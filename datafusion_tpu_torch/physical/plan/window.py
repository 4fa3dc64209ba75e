"""WindowExec — window function evaluation.

Reference parity: `windows/window_agg_exec.rs:173` (full-buffer evaluation;
the incremental BoundedWindowAggExec is a later optimization), built-in
window exprs (`physical-expr/src/window/` rank.rs, lead_lag.rs,
nth_value.rs, row_number.rs, cume_dist.rs, ntile.rs) and the frame spec
(`expr/src/window_frame.rs:41`).

Host path: the input is buffered, rows are ordered by (partition keys,
order keys) once, every function is computed vectorized over that ordering
(ranks via run-length/dedup scans, frame aggregates via prefix sums —
the same scan-based formulation the device path uses), and results are
scattered back to original row order.

Device path: on the plan's device (given by the `UseTorchSort` rule), a
window function of the supported family over at least
`datafusion.tpu.device_window_min_rows` rows evaluates in
`device/window.py` (radix sort, lane gather, window scan); other orderings
of at least `datafusion.tpu.device_sort_min_rows` rows sort there
(`sort.lexsort`).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

from ...common import dt
from ...common.batch import Batch
from ...common.column import Column
from ...common.errors import ExecutionError
from ...common.schema import Field, Schema
from ...expr.expr import WindowFrame, WindowFrameBound
from ...runtime import BaselineMetrics, TaskContext
from .. import kernels as K
from ..expressions import PhysicalExpr
from ..hashing import factorize, factorize_column
from .base import ExecutionPlan, Partitioning
from .sort import PhysSortExpr, encode_order_key, lexsort, order_keys


@dataclasses.dataclass
class PhysWindowExpr:
    name: str
    args: List[PhysicalExpr]
    partition_by: List[PhysicalExpr]
    order_by: List[PhysSortExpr]
    frame: WindowFrame
    out_type: object
    display: str
    ignore_nulls: bool = False


class WindowExec(ExecutionPlan):
    def __init__(self, window_exprs: List[PhysWindowExpr], input: ExecutionPlan,
                 linear: bool = False, device=None):
        super().__init__()
        self.window_exprs = window_exprs
        self.input = input
        self.device = device     # large windows run there (None: the host)
        # window evaluations that ran on the host though the device could
        # have taken their input (a function outside the device family)
        self.fallbacks = 0
        # Linear mode (reference: BoundedWindowAggExec mode=[Linear]):
        # partitions tracked by hash, no sort below, rows leave in INPUT
        # order — used when sorting is impossible (unbounded input)
        self.linear = linear
        fields = list(input.schema().fields)
        for w in window_exprs:
            fields.append(Field(w.display, w.out_type, True))
        self._schema = Schema(fields)

    def schema(self):
        return self._schema

    def children(self):
        return [self.input]

    def with_children(self, c):
        return WindowExec(self.window_exprs, c[0], self.linear, self.device)

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        from .base import collect_batch
        m = BaselineMetrics(self.metrics, partition)
        batch = collect_batch(self.input, ctx)
        if batch.num_rows == 0:
            return
        with m.elapsed_compute:
            # PlaceholderRowExec emits a dummy column its (empty) schema
            # does not declare — keep output columns schema-aligned
            n_base = len(self.input.schema())
            cols = list(batch.columns[:n_base])
            for w in _plan_window_evaluation(self.window_exprs,
                                             self.input.output_ordering()):
                cols.append(_eval_window(w, batch, metrics=m,
                                         config=ctx.config,
                                         device=self.device, owner=self))
            out = Batch(self._schema, cols, batch.num_rows)
            # the reference plans the postgres-style FIRST window group's
            # sort at the bottom and computes later groups in reversed /
            # re-sorted mode above it, so rows leave in the first-sorted
            # group's ordering (builder.rs:330 window_plan sort +
            # enforce_sorting reversed window exprs) — match it for
            # bit-identical unordered output
            key = None if self.linear else _output_sort_key(
                self.window_exprs, self.input.output_ordering())
            if key:
                out = out.take_host(_order_for_key(
                    key, batch, metrics=m, device=self.device,
                    config=ctx.config))
        m.record_output(out.num_rows)
        yield out

    def maintains_input_order(self):
        return self.linear or _output_sort_key(
            self.window_exprs, self.input.output_ordering()) is None

    def output_ordering(self):
        o = self.output_orderings()
        return o[0] if o else None

    def output_orderings(self):
        if self.linear:
            return self.input.output_orderings()
        key = _output_sort_key(self.window_exprs,
                               self.input.output_ordering())
        if key is None:
            base = self.input.output_ordering() or []
        else:
            base = [(str(e), a, nf) for e, a, nf, _p in key]
        out = [base] if base else []
        # an un-partitioned ROW_NUMBER whose sort is satisfied by the final
        # ordering is strictly increasing in output order — it leads an
        # equivalent ordering (reference: window exprs add orderings to
        # EquivalenceProperties, windows/mod.rs window_equivalence_properties)
        cur = [(sname, a, nf, False) for sname, a, nf in base]
        n_in = len(self.input.schema())
        for i, w in enumerate(self.window_exprs):
            if w.name == "row_number" and not w.partition_by and \
                    _key_satisfies(cur, _window_sort_key(w)):
                col = f"{w.display}@{n_in + i}"
                out.insert(0, [(col, True, False)] + base)
        return out

    def equivalence_properties(self):
        """Child properties plus the window-created orderings (reference:
        windows/mod.rs window_equivalence_properties — monotonic window
        exprs like un-partitioned ROW_NUMBER add orderings)."""
        from ..equivalence import EquivalenceProperties
        if self.maintains_input_order():
            props = self.input.equivalence_properties().copy()
        else:
            props = EquivalenceProperties()
        for o in self.output_orderings():
            props.add_ordering(o)
        return props

    def display_line(self):
        return "WindowExec: " + ", ".join(w.display for w in self.window_exprs)


class BoundedWindowExec(WindowExec):
    """Bounded-memory window over input SORTED by the shared partition
    keys: rows buffer only until the partition-key run ends, then the run
    evaluates and streams out (reference:
    windows/bounded_window_agg_exec.rs). Requires every window expr to
    share the same non-empty PARTITION BY; the planner inserts the
    partition-key sort below."""

    def __init__(self, window_exprs: List[PhysWindowExpr],
                 input: ExecutionPlan, device=None):
        super().__init__(window_exprs, input, device=device)
        pb = window_exprs[0].partition_by
        assert pb and all(
            [str(e) for e in w.partition_by] == [str(e) for e in pb]
            for w in window_exprs), "BoundedWindowExec needs a shared PARTITION BY"

    def with_children(self, c):
        return BoundedWindowExec(self.window_exprs, c[0], self.device)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        from ...common.batch import concat_batches
        from .base import execute_stream
        m = BaselineMetrics(self.metrics, partition)
        pb_exprs = self.window_exprs[0].partition_by
        pending: List[Batch] = []
        pending_key = None

        def run_out(run_batches):
            merged = run_batches[0] if len(run_batches) == 1 else \
                concat_batches(self.input.schema(), run_batches)
            cols = list(merged.columns)
            for w in _plan_window_evaluation(self.window_exprs,
                                             self.input.output_ordering()):
                cols.append(_eval_window(w, merged, metrics=m,
                                         config=ctx.config,
                                         device=self.device, owner=self))
            out = Batch(self._schema, cols, merged.num_rows)
            key = _output_sort_key(self.window_exprs,
                                   self.input.output_ordering())
            if key:   # rows leave in the primary group's ordering (see
                # WindowExec.execute); partition keys are constant per run
                out = out.take_host(_order_for_key(
                    key, merged, metrics=m, device=self.device,
                    config=ctx.config))
            return out

        for b in execute_stream(self.input, ctx):
            if not b.num_rows:
                continue
            with m.elapsed_compute:
                keys = [factorize_column(e.evaluate(b)) for e in pb_exprs]
                change = np.zeros(b.num_rows, bool)
                for k in keys:
                    change[1:] |= k[1:] != k[:-1]
                first = tuple(
                    e.evaluate(b).to_pylist(1)[0] for e in pb_exprs)
                if pending_key is not None and first != pending_key:
                    change[0] = True
                bounds = np.nonzero(change)[0]
                outs = []
                start = 0
                for cut in bounds:
                    if cut > start:
                        pending.append(b.take_host(np.arange(start, cut)))
                    if pending:
                        outs.append(run_out(pending))
                    pending = []
                    start = cut
                pending.append(b.take_host(np.arange(start, b.num_rows)))
                last_i = b.num_rows - 1
                pending_key = tuple(
                    e.evaluate(b).slice_host(last_i, 1).to_pylist(1)[0]
                    for e in pb_exprs)
            for o in outs:
                m.record_output(o.num_rows)
                yield o
        if pending:
            with m.elapsed_compute:
                out = run_out(pending)
            m.record_output(out.num_rows)
            yield out

    def display_line(self):
        return "BoundedWindowAggExec: " + \
            ", ".join(w.display for w in self.window_exprs)


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------

def _expr_ref_indexes(e) -> List[int]:
    """Column indexes referenced by a physical expr, in traversal order
    (reference: find_column_indexes_referenced_by_expr, expr/src/utils.rs)."""
    from ..expressions import ColumnExpr
    out: List[int] = []

    def walk(x):
        if isinstance(x, ColumnExpr):
            out.append(x.index)
        for c in x.children():
            walk(c)
    walk(e)
    return out


def _window_sort_key(w: PhysWindowExpr):
    """(expr, asc, nulls_first, is_partition) sort key: partition keys
    (default ASC NULLS LAST, upgraded to the matching ORDER BY spec) then
    order keys (reference: generate_sort_key, expr/src/utils.rs:465)."""
    keys = []
    seen = set()
    ob_strs = [str(se.expr) for se in w.order_by]
    for e in w.partition_by:
        es = str(e)
        if es in seen:
            continue
        seen.add(es)
        if es in ob_strs:
            se = w.order_by[ob_strs.index(es)]
            keys.append((se.expr, se.asc, se.nulls_first, True))
        else:
            keys.append((e, True, False, True))
    for se in w.order_by:
        if str(se.expr) not in seen:
            seen.add(str(se.expr))
            keys.append((se.expr, se.asc, se.nulls_first, False))
    return keys


def _cmp_window_keys(ka, kb) -> int:
    """PostgreSQL common_prefix_cmp (reference: compare_sort_expr,
    expr/src/utils.rs:512 + window_plan tie-break builder.rs:335-349)."""
    for (ea, asc_a, nf_a, _pa), (eb, asc_b, nf_b, _pb) in zip(ka, kb):
        ia, ib = _expr_ref_indexes(ea), _expr_ref_indexes(eb)
        for x, y in zip(ia, ib):
            if x != y:
                return -1 if x < y else 1
        if len(ia) != len(ib):
            return 1 if len(ia) < len(ib) else -1
        if asc_a != asc_b:
            return 1 if asc_a else -1
        if nf_a != nf_b:
            return -1 if nf_a else 1
    if len(ka) != len(kb):
        return -1 if len(ka) > len(kb) else 1
    return 0


# window functions with no reversed form: a group containing one forces a
# re-sort instead of reversed evaluation (reference: get_reverse_expr
# returning None — physical-expr/src/window/{row_number,rank,ntile,...}.rs)
_IRREVERSIBLE_FNS = frozenset({
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile",
})


def _key_satisfies(cur, need) -> bool:
    """`need` is satisfied by existing ordering `cur` when it is a prefix:
    the PARTITION BY entries match the leading cur entries as a SET
    (direction- and order-free), the ORDER BY tail matches positionally
    (reference: get_window_mode partition search + ordering satisfy)."""
    if len(need) > len(cur):
        return False
    n_part = sum(1 for e in need if e[3])
    part_exprs = {str(e[0]) for e in need[:n_part]}
    if {str(c[0]) for c in cur[:n_part]} != part_exprs:
        return False
    for (ce, ca, cn, _cp), (ne, na, nn, np_) in zip(cur[n_part:],
                                                    need[n_part:]):
        if str(ce) != str(ne):
            return False
        if not np_ and (ca != na or cn != nn):
            return False
    return True


def _reverse_key(k):
    return [(e, not a, not nf, p) for (e, a, nf, p) in k]


def _output_sort_key(window_exprs: List[PhysWindowExpr],
                     input_ordering=None):
    """The ordering rows leave a window stack with: groups sort
    postgres-style (builder.rs:330); a group whose requirement is already
    met by the current ordering (directly, or reversed when every fn has a
    reverse form) adds no sort, otherwise its sort becomes the new output
    ordering (reference: enforce_sorting get_window_mode + reversed window
    exprs). Returns None when the INPUT ordering survives untouched."""
    import functools
    groups = []   # (key, [fn names], signature)
    for w in window_exprs:
        k = _window_sort_key(w)
        sig = [(str(e), a, nf, p) for e, a, nf, p in k]
        for g in groups:
            if g[2] == sig:
                g[1].append(w.name)
                break
        else:
            groups.append((k, [w.name], sig))
    groups.sort(key=functools.cmp_to_key(
        lambda a, b: _cmp_window_keys(a[0], b[0])))
    # seed with the child's delivered ordering (string-keyed entries;
    # _key_satisfies compares by display string)
    cur = [(sname, a, nf, False) for sname, a, nf in (input_ordering or [])]
    cur_is_input = True
    for key, fns, _sig in groups:
        if _key_satisfies(cur, key):
            continue
        if _key_satisfies(_reverse_key(cur), key) and \
                not any(f in _IRREVERSIBLE_FNS for f in fns):
            continue
        cur = key
        cur_is_input = False
    return None if cur_is_input else cur


_REVERSIBLE_AGGS = frozenset({"sum", "count", "avg", "mean", "min", "max",
                              "first_value", "last_value", "nth_value",
                              "lead", "lag"})


def _reversed_window(w: PhysWindowExpr) -> PhysWindowExpr:
    """The reversed form: flipped ORDER BY + mirrored frame, with
    first<->last, lead<->lag and nth(k)->nth(-k) swaps (reference:
    WindowExpr::get_reverse_expr impls). Values per row are identical; tie
    iteration inside equal order keys matches the reference's
    reversed-execution path."""
    from ..expressions import NegativeExpr
    rev = {"PRECEDING": "FOLLOWING", "FOLLOWING": "PRECEDING",
           "UNBOUNDED_PRECEDING": "UNBOUNDED_FOLLOWING",
           "UNBOUNDED_FOLLOWING": "UNBOUNDED_PRECEDING"}

    def revb(b):
        return WindowFrameBound(rev.get(b.kind, b.kind), b.offset)

    ob = [PhysSortExpr(se.expr, not se.asc, not se.nulls_first)
          for se in w.order_by]
    frame = WindowFrame(w.frame.units, revb(w.frame.end), revb(w.frame.start))
    name = {"first_value": "last_value", "last_value": "first_value",
            "lead": "lag", "lag": "lead"}.get(w.name, w.name)
    args = list(w.args)
    if w.name == "nth_value" and len(args) > 1:
        args[1] = NegativeExpr(args[1], args[1].out_type)
    return dataclasses.replace(w, name=name, args=args, order_by=ob,
                               frame=frame)


def _plan_window_evaluation(window_exprs: List[PhysWindowExpr],
                            input_ordering=None):
    """Decide per window whether to evaluate it directly or reversed,
    mirroring enforce_sorting's get_window_mode over the stacked groups."""
    import functools
    groups = []
    for i, w in enumerate(window_exprs):
        k = _window_sort_key(w)
        sig = [(str(e), a, nf, p) for e, a, nf, p in k]
        for g in groups:
            if g[2] == sig:
                g[1].append(i)
                break
        else:
            groups.append((k, [i], sig))
    groups.sort(key=functools.cmp_to_key(
        lambda a, b: _cmp_window_keys(a[0], b[0])))
    cur = [(sname, a, nf, False) for sname, a, nf in (input_ordering or [])]
    out = {}
    for key, idxs, _sig in groups:
        if _key_satisfies(cur, key):
            for i in idxs:
                out[i] = window_exprs[i]
            continue
        if _key_satisfies(_reverse_key(cur), key) and all(
                window_exprs[i].name in _REVERSIBLE_AGGS for i in idxs):
            for i in idxs:
                out[i] = _reversed_window(window_exprs[i])
            continue
        cur = key
        for i in idxs:
            out[i] = window_exprs[i]
    return [out[i] for i in range(len(window_exprs))]


def _order_for_key(key, batch: Batch, metrics=None, device=None,
                   config=None):
    """Stable lexsort order for a [(expr, asc, nulls_first, is_part)] key.
    Large inputs sort on the plan's device (`sort.lexsort`)."""
    ks = []
    for e, asc, nf, _p in key:
        rank, kk = order_keys(e.evaluate(batch), asc, nf)
        ks.append(rank)
        ks.append(kk)
    return lexsort(ks, batch.num_rows, device=device, config=config)


def _window_order(w: PhysWindowExpr, batch: Batch, metrics=None,
                  device=None, config=None):
    """(order, pids): partition-major stable sort order for one window.
    Large inputs sort on the plan's device (`sort.lexsort`)."""
    n = batch.num_rows
    if w.partition_by:
        pcols = [e.evaluate(batch) for e in w.partition_by]
        pids, _, _ = factorize(pcols, n)
    else:
        pids = np.zeros(n, np.int64)
    keys = [pids.astype(np.uint64)]
    for se in w.order_by:
        rank, key = order_keys(se.expr.evaluate(batch), se.asc,
                               se.nulls_first)
        keys.append(rank)
        keys.append(key)
    return lexsort(keys, n, device=device, config=config), pids


def device_window_inputs(w: PhysWindowExpr, batch: Batch):
    """What `device/window.py` evaluates for `w` over `batch`: (spec,
    partition words, order words, lanes {arg, arg_valid, default,
    default_valid} as host arrays, the argument column), or None when the
    function or its frame falls outside the device family (the JAX
    package's `_try_device_window`, `plan/window.py:464-565`)."""
    n = batch.num_rows
    name = w.name
    frame = w.frame

    spec = None
    arg = arg_valid = default = default_valid = None
    arg_col = None
    if name in ("row_number", "rank", "dense_rank", "percent_rank",
                "cume_dist"):
        spec = ("rank", name)
    elif name == "ntile" and w.args:
        from ..expressions import LiteralExpr
        if isinstance(w.args[0], LiteralExpr):
            k = int(w.args[0].evaluate(batch).to_pylist(1)[0])
            if k <= 0:
                raise ExecutionError("NTILE requires a positive integer")
            spec = ("ntile", min(k, n))
    elif name in ("lag", "lead") and not w.ignore_nulls and w.args:
        from ..expressions import LiteralExpr
        if all(isinstance(a, LiteralExpr) for a in w.args[1:2]):
            off = 1
            if len(w.args) > 1:
                off = int(w.args[1].evaluate(batch).data_host()[0])
            shift = -off if name == "lag" else off
            arg_col = w.args[0].evaluate(batch)
            if len(w.args) > 2:
                d = w.args[2].evaluate(batch)
                if arg_col.dtype.is_string and d.dtype.is_string:
                    arg_col, d = K.unify_dictionaries(arg_col, d)
                elif arg_col.dtype != d.dtype:
                    return None
                default = d.data_host()
                default_valid = K.valid_mask(d)
            spec = ("shift", shift)
            arg = arg_col.data_host()
            arg_valid = K.valid_mask(arg_col)
    elif name in ("sum", "count", "avg", "mean"):
        def bound(b, is_lo):
            if b.kind == "UNBOUNDED_PRECEDING":
                return ("part", 0)
            if b.kind == "UNBOUNDED_FOLLOWING":
                return ("part", 0)
            if b.kind == "CURRENT":
                if frame.units == "ROWS":
                    return ("cur", 0)
                return ("peer", 0)
            if frame.units != "ROWS" or b.offset is None or \
                    b.offset.value is None:
                return None
            off = int(b.offset.value)
            return ("rows", -off if b.kind == "PRECEDING" else off)
        if frame.units == "GROUPS":
            return None
        lo_b = bound(frame.start, True)
        hi_b = bound(frame.end, False)
        if lo_b is None or hi_b is None:
            return None
        if w.args:
            arg_col = w.args[0].evaluate(batch)
            if arg_col.dtype.is_string or arg_col.dtype.is_dict_coded:
                return None
            if name in ("sum", "avg", "mean") and w.out_type.is_decimal:
                arg = arg_col.data_host().astype(np.int64)
                agg_kind = "sum_i"
            elif name == "count":
                agg_kind = "cnt"      # reads only the validity
            else:
                arg = K.cast_column(arg_col, dt.FLOAT64).data_host()
                agg_kind = "sum_f"
            arg_valid = K.valid_mask(arg_col)
        else:
            if name != "count":
                return None
            arg_valid = np.ones(n, bool)
            agg_kind = "cnt"
        spec = ("agg", agg_kind, lo_b[0], lo_b[1], hi_b[0], hi_b[1])
    if spec is None:
        return None

    part_words: List[np.ndarray] = []
    for e in w.partition_by:
        r, k = order_keys(e.evaluate(batch), True, False)
        part_words.append(r)
        part_words.append(k)
    order_words: List[np.ndarray] = []
    for se in w.order_by:
        r, k = order_keys(se.expr.evaluate(batch), se.asc, se.nulls_first)
        order_words.append(r)
        order_words.append(k)
    if not part_words and not order_words:
        # one partition of peers: a constant word keeps the sort defined
        part_words.append(np.zeros(n, np.uint8))
    lanes = {"arg": arg, "arg_valid": arg_valid, "default": default,
             "default_valid": default_valid}
    return spec, part_words, order_words, lanes, arg_col


def _try_device_window(w: PhysWindowExpr, batch: Batch, metrics=None,
                       config=None, device=None) -> Optional[Column]:
    """Device evaluation of the hot window family (`device/window.py`:
    radix sort, lane gather, window scan on the plan's device), finalized
    on the host as the host path finalizes. Returns None when there is no
    device, the input is below `datafusion.tpu.device_window_min_rows`,
    or the function or frame falls outside the family."""
    from ...device.window import device_window_eval, min_rows
    n = batch.num_rows
    if device is None or n < min_rows(config):
        return None
    with record_function("dft.window.encode"):
        inputs = device_window_inputs(w, batch)
    if inputs is None:
        return None
    spec, part_words, order_words, lanes, arg_col = inputs
    out = device_window_eval(part_words, order_words, n, spec, **lanes,
                             device=device)
    del part_words, order_words, lanes
    with record_function("dft.window.finalize"):
        return _finalize_device_window(w, spec, out, arg_col)


def _finalize_device_window(w: PhysWindowExpr, spec, out, arg_col) -> Column:
    """The device outputs of `w` as its column, as the host path builds
    it: decimal averages rounded, validity from counts, lag/lead values
    in the argument's type and dictionary."""
    name = w.name
    if spec[0] == "rank":
        if name in ("percent_rank", "cume_dist"):
            return Column(dt.FLOAT64, out["data"].astype(np.float64))
        return Column(dt.UINT64, out["data"].astype(np.uint64))
    if spec[0] == "ntile":
        return Column(dt.UINT64, out["data"].astype(np.uint64))
    if spec[0] == "shift":
        v = out["valid"].astype(bool)
        return Column(arg_col.dtype, out["data"],
                      None if v.all() else v, arg_col.dictionary)
    # agg: finalize sum / count / avg exactly like the host twin
    cnt = out["cnt"].astype(np.int64)
    if name == "count":
        return Column(dt.INT64, cnt)
    s = out["sum"]
    has = cnt > 0
    if name == "sum":
        if w.out_type.is_decimal or w.out_type.is_integer:
            return Column(w.out_type, s.astype(w.out_type.device_dtype()),
                          None if has.all() else has)
        return Column(dt.FLOAT64, s.astype(np.float64),
                      None if has.all() else has)
    safe = np.where(has, cnt, 1)
    if w.out_type.is_decimal:
        shift10 = 10 ** (w.out_type.scale - arg_col.dtype.scale)
        num = s.astype(object) * int(shift10)
        q = np.sign(num) * ((np.abs(num) + safe // 2) // safe)
        return Column(w.out_type, q.astype(np.int64),
                      None if has.all() else has)
    return Column(dt.FLOAT64, s / safe, None if has.all() else has)


def _eval_window(w: PhysWindowExpr, batch: Batch, metrics=None,
                 config=None, device=None, owner=None) -> Column:
    """`w` over `batch`: on `device` when it can (`_try_device_window`),
    else on the host. A window that a device could have taken (input at or
    above the threshold) but that runs on the host adds one to
    `owner.fallbacks`."""
    from ...device.window import min_rows
    n = batch.num_rows
    dev = _try_device_window(w, batch, metrics=metrics, config=config,
                             device=device)
    if dev is not None:
        return dev
    if owner is not None and device is not None and n >= min_rows(config):
        owner.fallbacks += 1
    order, pids = _window_order(w, batch, metrics=metrics, device=device,
                                config=config)
    sp = pids[order]                       # sorted partition ids
    # partition boundaries in sorted space
    part_start_mask = np.empty(n, bool)
    part_start_mask[0] = True
    part_start_mask[1:] = sp[1:] != sp[:-1]
    part_start = np.maximum.accumulate(np.where(part_start_mask, np.arange(n), 0))
    # index of the last row of each partition (nearest-next backward fill)
    last_mask = np.empty(n, bool)
    last_mask[-1] = True
    last_mask[:-1] = sp[1:] != sp[:-1]
    idx = np.arange(n)
    part_end = np.flip(_segmented_ffill(np.flip(np.where(last_mask, idx, 0)),
                                        np.flip(last_mask)))
    row_in_part = idx - part_start
    part_len = part_end - part_start + 1

    # peer groups (rows equal on order keys within partition)
    if w.order_by:
        okeys = [w_[order] for se in w.order_by
                 for w_ in order_keys(se.expr.evaluate(batch), se.asc,
                                      se.nulls_first)]
        new_peer = part_start_mask.copy()
        for k in okeys:
            new_peer |= np.concatenate([[True], k[1:] != k[:-1]])
    else:
        new_peer = part_start_mask.copy()

    name = w.name
    sorted_out: Column

    if name == "row_number":
        sorted_out = Column(dt.UINT64, (row_in_part + 1).astype(np.uint64))
    elif name == "rank":
        rank_at_peer = np.where(new_peer, row_in_part + 1, 0)
        sorted_out = Column(dt.UINT64, _segmented_ffill(rank_at_peer, new_peer).astype(np.uint64))
    elif name == "dense_rank":
        incr = new_peer & ~part_start_mask
        dr = np.cumsum(incr) + 1
        base = _segmented_ffill(np.where(part_start_mask, dr, 0), part_start_mask)
        sorted_out = Column(dt.UINT64, (dr - base + 1).astype(np.uint64))
    elif name == "percent_rank":
        rank = _segmented_ffill(np.where(new_peer, row_in_part + 1, 0), new_peer)
        denom = np.maximum(part_len - 1, 1).astype(np.float64)
        sorted_out = Column(dt.FLOAT64, (rank - 1) / denom)
    elif name == "cume_dist":
        # rows <= current peer group (peer-group end position) / partition size
        peer_end = _peer_group_end(new_peer, idx, n)
        sorted_out = Column(dt.FLOAT64,
                            (peer_end - part_start + 1) / part_len.astype(np.float64))
    elif name == "ntile":
        k = int(w.args[0].evaluate(batch).to_pylist(1)[0]) if w.args else 1
        if k <= 0:
            raise ExecutionError("NTILE requires a positive integer")
        k = min(k, n)  # reference saturates huge (u64) bucket counts
        sorted_out = Column(dt.UINT64,
                            np.minimum((row_in_part * k // np.maximum(part_len, 1)) + 1,
                                       k).astype(np.uint64))
    elif name in ("lag", "lead"):
        from ..expressions import LiteralExpr
        for ai, a in enumerate(w.args[1:], start=1):
            if not isinstance(a, LiteralExpr):
                raise ExecutionError(
                    f"There is only support Literal types for field at idx: "
                    f"{ai} in Window Function: {name}")
        c = w.args[0].evaluate(batch).take_host(order)
        off = 1
        if len(w.args) > 1:
            off = int(w.args[1].evaluate(batch).data_host()[0])
        default = w.args[2].evaluate(batch).take_host(order) if len(w.args) > 2 else None
        shift = -off if name == "lag" else off
        if w.ignore_nulls:
            # offset counts only non-NULL values (reference: lead_lag.rs
            # IGNORE NULLS): map each row to the k-th previous/next valid
            # row within the partition
            cv = K.valid_mask(c)
            pos = np.cumsum(cv) - 1          # index into valid-only array
            valid_idx = np.flatnonzero(cv)
            if name == "lag":
                tgt = np.where(cv, pos, pos + 1) - off
            else:
                tgt = pos + off
            ok = (tgt >= 0) & (tgt < len(valid_idx))
            src = np.where(ok, valid_idx[np.clip(tgt, 0, max(len(valid_idx) - 1, 0))], -1)
            in_part = ok & (src >= part_start) & (src <= part_end)
            src = np.where(in_part, src, 0)
        else:
            src = idx + shift
            in_part = (src >= part_start) & (src <= part_end)
        safe = np.clip(src, 0, n - 1)
        data = c.data_host()[safe]
        v = K.valid_mask(c)[safe]
        if default is not None:
            ddata = default.data_host()
            dv = K.valid_mask(default)
            if c.dtype.is_string and default.dtype.is_string:
                cc, dd = K.unify_dictionaries(c, default)
                data = cc.data_host()[safe]
                ddata = dd.data_host()
                c = cc
            data = np.where(in_part, data, ddata)
            v = np.where(in_part, v, dv)
        else:
            v = v & in_part
        sorted_out = Column(c.dtype, data, None if v.all() else v, c.dictionary)
    elif name in ("first_value", "last_value", "nth_value"):
        # evaluated over the window FRAME, not the whole partition
        # (reference: physical-expr/src/window/nth_value.rs)
        c = w.args[0].evaluate(batch).take_host(order)
        lo, hi, empty = _frame_bounds(w, batch, order, idx, part_start,
                                      part_end, new_peer)
        k = 1
        if name == "nth_value":
            k = int(w.args[1].evaluate(batch).data_host()[0])
            if k == 0:
                raise ExecutionError("nth_value expect n to be > 0")
        if w.ignore_nulls:
            # positions counted over non-NULL values only (reference:
            # nth_value.rs IGNORE NULLS)
            cv = K.valid_mask(c)
            vidx = np.flatnonzero(cv)
            if len(vidx) == 0:
                sorted_out = Column(c.dtype, np.zeros(n, c.dtype.device_dtype()),
                                    np.zeros(n, bool), c.dictionary)
            else:
                first_pos = np.searchsorted(vidx, lo, side="left")
                last_pos = np.searchsorted(vidx, hi, side="right") - 1
                if name == "first_value":
                    pos = first_pos
                elif name == "last_value":
                    pos = last_pos
                else:
                    pos = first_pos + (k - 1) if k > 0 else last_pos + k + 1
                ok = (pos >= first_pos) & (pos <= last_pos) & ~empty & \
                    (first_pos <= last_pos)
                src = vidx[np.clip(pos, 0, len(vidx) - 1)]
                data = c.data_host()[src]
                sorted_out = Column(c.dtype, data,
                                    None if ok.all() else ok, c.dictionary)
        else:
            if name == "first_value":
                src = lo
            elif name == "last_value":
                src = hi
            else:
                src = lo + (k - 1) if k > 0 else hi + k + 1
            in_frame = (src >= lo) & (src <= hi) & ~empty
            safe = np.clip(src, 0, n - 1)
            data = c.data_host()[safe]
            v = K.valid_mask(c)[safe] & in_frame
            sorted_out = Column(c.dtype, data, None if v.all() else v, c.dictionary)
    else:
        from ...functions.udf import WINDOW_UDFS
        udwf = WINDOW_UDFS.get(name)
        if udwf is not None:
            # PartitionEvaluator protocol (reference:
            # expr/src/partition_evaluator.rs:89): args in sorted order +
            # partition bounds -> values in sorted order
            args_sorted = [w_arg.evaluate(batch).take_host(order).data_host()
                           for w_arg in w.args]
            vals = np.asarray(udwf.evaluator(args_sorted, part_start, part_end))
            sorted_out = Column(w.out_type, vals.astype(
                w.out_type.device_dtype()))
        else:
            sorted_out = _eval_window_aggregate(w, batch, order, pids,
                                                part_start, part_end, new_peer)

    # scatter back to original row order
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    return sorted_out.take_host(inv)


def _shift_bool(new_peer: np.ndarray) -> np.ndarray:
    """Mask of 'last row of its peer group'."""
    out = np.empty(len(new_peer), bool)
    out[:-1] = new_peer[1:]
    out[-1] = True
    return out


def _peer_group_end(new_peer, idx, n):
    last_of_peer = _shift_bool(new_peer)
    return np.flip(_segmented_ffill(np.flip(np.where(last_of_peer, idx, 0)),
                                    np.flip(last_of_peer)))


def _segmented_ffill(vals: np.ndarray, set_mask: np.ndarray) -> np.ndarray:
    """Forward-fill vals from positions where set_mask is True."""
    idx = np.where(set_mask, np.arange(len(vals)), 0)
    idx = np.maximum.accumulate(idx)
    return vals[idx]


def _frame_bounds(w: PhysWindowExpr, batch: Batch, order, idx, part_start,
                  part_end, new_peer):
    """Frame bounds [lo, hi] inclusive in sorted-row space, plus the
    empty-frame mask (reference: window_frame_state.rs per-units logic)."""
    n = len(idx)
    frame = w.frame
    if frame.units == "ROWS":
        lo = _bound_rows(frame.start, idx, part_start, part_end, True)
        hi = _bound_rows(frame.end, idx, part_start, part_end, False)
    elif frame.units == "GROUPS":
        # offsets counted in peer groups (reference: window_frame.rs GROUPS)
        peer_idx = np.cumsum(new_peer) - 1

        def off(b):
            return int(b.offset.value) if b.offset is not None and \
                b.offset.value is not None else 0
        if frame.start.kind == "UNBOUNDED_PRECEDING":
            lo = part_start.copy()
        else:
            delta = -off(frame.start) if frame.start.kind == "PRECEDING" else \
                (off(frame.start) if frame.start.kind == "FOLLOWING" else 0)
            target = peer_idx + delta
            lo = np.searchsorted(peer_idx, target, side="left")
        if frame.end.kind == "UNBOUNDED_FOLLOWING":
            hi = part_end.copy()
        else:
            delta = -off(frame.end) if frame.end.kind == "PRECEDING" else \
                (off(frame.end) if frame.end.kind == "FOLLOWING" else 0)
            target = peer_idx + delta
            hi = np.searchsorted(peer_idx, target, side="right") - 1
    else:  # RANGE: peer groups for UNBOUNDED/CURRENT, value search for offsets
        peer_start = _segmented_ffill(np.where(new_peer, idx, 0), new_peer)
        peer_end = _peer_group_end(new_peer, idx, n)
        lo = np.where(
            frame.start.kind == "UNBOUNDED_PRECEDING", part_start,
            np.where(frame.start.kind == "CURRENT", peer_start, part_start))
        hi = np.where(
            frame.end.kind == "UNBOUNDED_FOLLOWING", part_end,
            np.where(frame.end.kind == "CURRENT", peer_end, part_end))
        if frame.start.kind in ("PRECEDING", "FOLLOWING") or \
           frame.end.kind in ("PRECEDING", "FOLLOWING"):
            if not w.order_by:
                raise ExecutionError("RANGE with offset requires ORDER BY")
            lo, hi = _range_offset_bounds(w, batch, order, part_start, part_end)
    lo = np.maximum(lo, part_start)
    hi = np.minimum(hi, part_end)
    return lo, hi, lo > hi


def _eval_window_aggregate(w: PhysWindowExpr, batch: Batch, order, pids,
                           part_start, part_end, new_peer) -> Column:
    """Aggregate function over a window frame, computed with prefix sums in
    sorted space."""
    n = batch.num_rows
    idx = np.arange(n)
    name = w.name
    lo, hi, empty = _frame_bounds(w, batch, order, idx, part_start,
                                  part_end, new_peer)

    if not w.args:
        vals = None
        valid = np.ones(n, bool)
        xtype = dt.INT64
    else:
        c = w.args[0].evaluate(batch).take_host(order)
        valid = K.valid_mask(c)
        xtype = c.dtype
        vals = c

    if name == "count":
        cnt = _frame_sum(valid.astype(np.int64), lo, hi)
        cnt = np.where(empty, 0, cnt)
        return Column(dt.INT64, cnt)
    if name in ("sum", "avg", "mean"):
        x = K.cast_column(vals, dt.FLOAT64).data_host() if not w.out_type.is_decimal \
            else vals.data_host().astype(np.int64)
        x = np.where(valid, x, 0)
        s = _frame_sum(x, lo, hi)
        cnt = _frame_sum(valid.astype(np.int64), lo, hi)
        has = (cnt > 0) & ~empty
        if name == "sum":
            if w.out_type.is_decimal or w.out_type.is_integer:
                return Column(w.out_type, s.astype(w.out_type.device_dtype()),
                              None if has.all() else has)
            return Column(dt.FLOAT64, s.astype(np.float64),
                          None if has.all() else has)
        safe = np.where(has, cnt, 1)
        if w.out_type.is_decimal:
            shift = 10 ** (w.out_type.scale - xtype.scale)
            num = s.astype(object) * int(shift)
            q = np.sign(num) * ((np.abs(num) + safe // 2) // safe)
            return Column(w.out_type, q.astype(np.int64), None if has.all() else has)
        return Column(dt.FLOAT64, s / safe, None if has.all() else has)
    if name in ("min", "max"):
        # O(n log n) sparse-table sliding min/max
        x = vals.data_host()
        key = encode_order_key(vals, name == "min", False)
        res_idx = _range_argopt(key, lo, hi)
        data = x[res_idx]
        v = valid[res_idx] & ~empty
        return Column(xtype, data, None if v.all() else v, vals.dictionary)
    if name in ("var", "variance", "var_samp", "var_pop",
                "stddev", "stddev_samp", "stddev_pop"):
        # sliding Welford with update/retract in the reference's exact FP
        # op order (variance.rs:251-287 + sliding_aggregate.rs:190-205:
        # update entering rows FIRST, then retract leaving rows) so results
        # match bit-for-bit, not just analytically
        import math
        xs = K.cast_column(vals, dt.FLOAT64).data_host().astype(np.float64)
        pop = name.endswith("_pop")
        is_std = name.startswith("stddev")
        out = np.zeros(n, np.float64)
        validity = np.ones(n, bool)
        count = 0
        mean = 0.0
        m2 = 0.0
        a = b = 0
        cur_part = -1
        for i in range(n):
            if part_start[i] != cur_part:
                cur_part = int(part_start[i])
                count, mean, m2 = 0, 0.0, 0.0
                a = b = cur_part
            l, h = int(lo[i]), int(hi[i]) + 1
            if empty[i] or l >= h:
                validity[i] = False
                continue
            for j in range(max(b, a), h):     # update entering rows
                if valid[j]:
                    vj = xs[j]
                    count += 1
                    d1 = vj - mean
                    mean = d1 / count + mean
                    m2 = m2 + d1 * (vj - mean)
            b = max(b, h)
            for j in range(a, l):             # retract leaving rows
                if valid[j]:
                    vj = xs[j]
                    nc = count - 1
                    if nc <= 0:
                        count, mean, m2 = 0, 0.0, 0.0
                    else:
                        d1 = mean - vj
                        nm = d1 / nc + mean
                        m2 = m2 - d1 * (nm - vj)
                        mean = nm
                        count = nc
            a = max(a, l)
            if count == 0 or (count == 1 and not pop):
                validity[i] = False
            else:
                denom = count if pop else count - 1
                v = m2 / denom
                out[i] = math.sqrt(v) if is_std else v
        return Column(dt.FLOAT64, out, None if validity.all() else validity)

    # generic fallback: run the aggregate's accumulator over each row's
    # frame slice (reference: WindowExpr aggregate evaluation; O(n*frame)
    # but covers every aggregate — regr_*, var, corr, median, ...)
    from ..aggregates import create_accumulator
    from ...functions.registry import aggregate_return_type
    arg_cols = [a.evaluate(batch).take_host(order) for a in w.args]
    out_type = w.out_type
    outs = []
    for i in range(n):
        acc = create_accumulator(
            name, [c.dtype for c in arg_cols], out_type)
        if not empty[i]:
            s, e = int(lo[i]), int(hi[i]) + 1
            sl = [c.slice_host(s, e - s) for c in arg_cols]
            acc.update(sl, np.zeros(e - s, np.int64), 1)
        col1 = acc.evaluate(1)
        outs.append(col1.to_pylist(1)[0])
    from ...common.column import Column as _C
    data = np.zeros(n, out_type.device_dtype())
    validity = np.ones(n, bool)
    dic = None
    if out_type.is_dict_coded:
        from ...common.column import Dictionary as _D
        vals = sorted({o for o in outs if o is not None})
        dic = _D(np.array(vals, dtype=object))
        data = np.array([dic.lookup(o) if o is not None else 0
                         for o in outs], np.int32)
    else:
        for i, o in enumerate(outs):
            if o is None:
                validity[i] = False
            else:
                data[i] = _scalar_to_device(o, out_type)
    return Column(out_type, data, None if validity.all() else validity, dic)


def _bound_rows(b, idx, part_start, part_end, is_start):
    if b.kind == "UNBOUNDED_PRECEDING":
        return part_start.copy()
    if b.kind == "UNBOUNDED_FOLLOWING":
        return part_end.copy()
    if b.kind == "CURRENT":
        return idx.copy()
    off = int(b.offset.value) if b.offset is not None and b.offset.value is not None else 0
    if b.kind == "PRECEDING":
        return idx - off
    return idx + off


def _range_offset_bounds(w, batch, order, part_start, part_end):
    """RANGE BETWEEN x PRECEDING AND y FOLLOWING over a single order key:
    binary-search value windows. Numeric keys use float offsets; temporal
    keys shift each row's key by the interval with calendar arithmetic
    (reference: window frame range calculation via arrow temporal kernels),
    staying in the exact int64 domain."""
    if len(w.order_by) != 1:
        raise ExecutionError("RANGE offset frame requires exactly one ORDER BY key")
    se = w.order_by[0]
    c = se.expr.evaluate(batch).take_host(order)
    frame = w.frame
    temporal = c.dtype.is_temporal

    def is_interval(b):
        return b.offset is not None and b.offset.dtype is not None \
            and b.offset.dtype.is_interval

    if temporal:
        from ...functions.datetime_impl import temporal_arith
        from ...functions.datetime_helpers import pack_interval
        x = c.data_host().astype(np.int64)

        def shifted(b, direction):
            # direction: -1 toward PRECEDING side, +1 toward FOLLOWING,
            # flipped for descending order
            if b.offset is None:
                return x
            sign = direction * (1 if se.asc else -1)
            op = "+" if sign > 0 else "-"
            if is_interval(b):
                m, d_, ns = b.offset.value
                packed = pack_interval(m, d_, ns)
            else:
                packed = pack_interval(0, 0, int(float(b.offset.value) * 1e9))
            iv = Column(dt.INTERVAL, np.full(len(x), packed, object), None)
            return temporal_arith(op, c, iv, c.dtype, None) \
                .data_host().astype(np.int64)
    else:
        for b in (frame.start, frame.end):
            if is_interval(b):
                raise ExecutionError(
                    f"Cannot use an interval RANGE offset over a "
                    f"{c.dtype} ORDER BY key")
        x = K.cast_column(c, dt.FLOAT64).data_host()

        def shifted(b, direction):
            off = float(b.offset.value) if b.offset is not None and \
                b.offset.value is not None else 0.0
            sign = direction * (1.0 if se.asc else -1.0)
            return x + sign * off

    lo_val = shifted(frame.start, -1) if frame.start.kind == "PRECEDING" else \
        (shifted(frame.start, +1) if frame.start.kind == "FOLLOWING" else None)
    hi_val = shifted(frame.end, +1) if frame.end.kind == "FOLLOWING" else \
        (shifted(frame.end, -1) if frame.end.kind == "PRECEDING" else None)
    # NULL order keys: a NULL row's frame is its NULL peer run; non-NULL
    # rows search only the non-NULL segment (reference:
    # window_frame_state.rs calculate_index_of_row NULL handling)
    valid = K.valid_mask(se.expr.evaluate(batch).take_host(order))
    n = len(x)
    if not valid.all():
        nulls_lead = bool(valid[part_start[0]] == False) if n else False  # noqa: E712
        # per-row bounds of the non-null segment within the partition
        vstart = part_start.copy()
        vend = part_end.copy()
        null_lo = np.zeros(n, np.int64)
        null_hi = np.zeros(n, np.int64)
        for ps in np.unique(part_start):
            pe = int(part_end[ps])
            seg = valid[ps:pe + 1]
            nn = np.flatnonzero(seg)
            if len(nn) == 0:
                vstart[ps:pe + 1] = ps
                vend[ps:pe + 1] = pe
                null_lo[ps:pe + 1] = ps
                null_hi[ps:pe + 1] = pe
                continue
            vstart[ps:pe + 1] = ps + nn[0]
            vend[ps:pe + 1] = ps + nn[-1]
            # the null run is contiguous at one end
            null_lo[ps:pe + 1] = ps if nn[0] > 0 else ps + nn[-1] + 1
            null_hi[ps:pe + 1] = ps + nn[0] - 1 if nn[0] > 0 else pe
        del nulls_lead
    else:
        vstart, vend = part_start, part_end
        null_lo = null_hi = None
    # per-partition searchsorted: x is sorted within partitions (by order key)
    lo = vstart.copy() if lo_val is None else _part_searchsorted(
        x, lo_val, vstart, vend, "left", se.asc)
    hi = vend.copy() if hi_val is None else _part_searchsorted(
        x, hi_val, vstart, vend, "right", se.asc) - 1
    if frame.start.kind == "UNBOUNDED_PRECEDING":
        lo = part_start.copy()
    if frame.end.kind == "UNBOUNDED_FOLLOWING":
        hi = part_end.copy()
    if frame.start.kind == "CURRENT":
        lo = _part_searchsorted(x, x, vstart, vend, "left", se.asc)
    if frame.end.kind == "CURRENT":
        hi = _part_searchsorted(x, x, vstart, vend, "right", se.asc) - 1
    if null_lo is not None:
        invalid = ~valid
        if frame.start.kind not in ("UNBOUNDED_PRECEDING",):
            lo = np.where(invalid, null_lo, lo)
        if frame.end.kind not in ("UNBOUNDED_FOLLOWING",):
            hi = np.where(invalid, null_hi, hi)
    return lo, hi


def _part_searchsorted(x, targets, part_start, part_end, side, asc):
    out = np.empty(len(x), np.int64)
    # loop per partition run (few partitions expected); vectorized within
    starts = np.unique(part_start)
    for s in starts:
        e = int(part_end[s]) + 1
        seg = x[s:e] if asc else -x[s:e]
        t = targets[s:e] if asc else -targets[s:e]
        out[s:e] = s + np.searchsorted(seg, t, side=side)
    return out


def _frame_sum(x: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    ps = np.concatenate([[0], np.cumsum(x)])
    return ps[np.clip(hi + 1, 0, len(x))] - ps[np.clip(lo, 0, len(x))]


def _range_argopt(key: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """argmin of `key` over [lo, hi] per row — sparse table (O(n log n))."""
    n = len(key)
    if n == 0:
        return np.zeros(0, np.int64)
    levels = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    table = np.zeros((levels, n), np.int64)
    table[0] = np.arange(n)
    length = 1
    for l in range(1, levels):
        prev = table[l - 1]
        shifted = np.concatenate([prev[length:], prev[-length:]]) if length < n \
            else prev
        better = key[shifted] < key[prev]
        table[l] = np.where(better, shifted, prev)
        length *= 2
    width = np.maximum(hi - lo + 1, 1)
    lvl = np.floor(np.log2(width)).astype(np.int64)
    half = (1 << lvl)
    a = table[lvl, np.clip(lo, 0, n - 1)]
    b = table[lvl, np.clip(hi - half + 1, 0, n - 1)]
    return np.where(key[b] < key[a], b, a)


def _scalar_to_device(v, out_type):
    """Python value from Column.to_pylist back to the device repr."""
    from decimal import Decimal as _Dec
    import datetime as _d
    if isinstance(v, _Dec):
        return int(v.scaleb(out_type.scale))
    if isinstance(v, _d.date) and not isinstance(v, _d.datetime):
        return (v - _d.date(1970, 1, 1)).days
    if isinstance(v, np.datetime64):
        return int(v.astype("int64"))
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float, np.integer, np.floating)):
        return v
    raise ExecutionError(f"unsupported window aggregate value {type(v)}")
