"""Compile PhysicalExpr trees into flat expression programs.

Counterpart of `datafusion_tpu/device/lower.py:56-511`. Where the JAX
package builds a traceable closure per expression and lets XLA fuse it,
the port compiles the same tree into a small stack program: int32-sized
opcodes with two arguments each, plus shared pools of int64 and float64
constants and host-computed auxiliary inputs (`AuxSpec`, resolved per
batch: string-literal positions, IN and LIKE lookup tables). The CUDA
kernel `csrc/fused_dense_aggregate.cu` interprets the program once per
row on a stack of `(64-bit value, valid bit)` entries; `evaluate` below
is the plain PyTorch interpreter of the same program over whole tensors.

Every stack value is an int64 or a float64. The program reproduces the
JAX package's narrower dtypes exactly with explicit int32 wrap (`WRAP32`) and
float32 rounding (`F32`) steps, so results match bit for bit.

The lowering covers what the reference's does (`lower.py:56-723`): columns,
literals, casts, Kleene logic, comparisons (string and decimal ones through
host-computed thresholds), `+ - * / %`, IN, LIKE, searched CASE, the
`_MATH` functions, `date_part` on the civil calendar, and uncorrelated
scalar subqueries (`DeferredScalarExpr`), whose value arrives through the
aux buffer at every execution. Unsupported constructs raise
`LoweringError`, as the reference does: `CASE <operand>`, decimal `/` and
`%`, temporal arithmetic, a tz-aware `date_part`, string scalar subqueries
and string-string comparisons stay on the host path.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.datatypes import TypeId
from ..expr.operator import Op
from ..physical import expressions as PE
from ..physical import kernels as K

# --- opcodes (mirrored in csrc/fused_dense_aggregate.cu) -------------------
OP_COL = 1        # a = column index: push (value, validity)
OP_ICONST = 2     # a = iconst index
OP_FCONST = 3     # a = fconst index
OP_NULL = 4       # push (0, invalid)
OP_ROWID = 5      # push the row index (the representative-row lane)
OP_ADD_I = 10
OP_SUB_I = 11
OP_MUL_I = 12
OP_ADD_F = 13
OP_SUB_F = 14
OP_MUL_F = 15
OP_NEG_I = 16
OP_NEG_F = 17
OP_MULC_I = 20    # top *= iconst[a]
OP_DIVC_F = 22    # top /= fconst[a]
OP_I2F = 23       # int64 -> float64
OP_F32 = 24       # round float64 to float32
OP_WRAP32 = 25    # wrap to int32 and sign-extend
OP_CMP_I = 30     # a = comparison code
OP_CMP_F = 31
OP_STRCMP = 32    # a = comparison code, b = aux slot (pos, exact)
OP_DECCMP = 33    # a = comparison code, b = iconst index of (t_ge, t_gt)
OP_LUT = 34       # a = aux slot of a bool table over dictionary codes
OP_IN_I = 35      # a = iconst start, b = count
OP_IN_F = 36      # a = fconst start, b = count
OP_AND = 40       # Kleene
OP_OR = 41        # Kleene
OP_NOT = 42
OP_ISNULL = 43
OP_ISNOTNULL = 44
OP_DIV_I = 50     # b = operand width (32, 64): lower.py:497-500
OP_MOD_I = 51     # b = operand width: lower.py:503-507
OP_DIV_F = 52
OP_MOD_F = 53
OP_SELECT = 54    # (acc, cond, then) -> cond true and valid ? then : acc
OP_MATH = 55      # a = MATH_* id, float64 in and out
OP_DATEPART = 56  # a = PART_* id, b = to_us (< 0: divide by -b)
OP_AUX = 58       # a = aux slot of (value bits, valid), b = 1 if float
OP_F2I = 59       # float64 -> int64, truncating (NaN 0, saturating)
OP_DECCMP_AUX = 60  # a = comparison code, b = aux slot of (t_ge, t_gt, valid)
# the opcodes from here on run only in the full variant of the kernels'
# interpreter (`run` in csrc/program.cuh)
FULL_OPS_FROM = OP_DIV_I

CMP_EQ, CMP_NE, CMP_LT, CMP_LE, CMP_GT, CMP_GE = range(6)
_CMP = {Op.EQ: CMP_EQ, Op.NEQ: CMP_NE, Op.LT: CMP_LT, Op.LTEQ: CMP_LE,
        Op.GT: CMP_GT, Op.GTEQ: CMP_GE}
_FLIP = {Op.LT: Op.GT, Op.LTEQ: Op.GTEQ, Op.GT: Op.LT, Op.GTEQ: Op.LTEQ}

# the `_MATH` functions of lower.py:596-600, by id (csrc/program.cuh)
MATH_FUNCS = ("abs", "sqrt", "exp", "ln", "log2", "log10", "sin", "cos",
              "tan", "floor", "ceil")
_MATH_ID = {f: i for i, f in enumerate(MATH_FUNCS)}


def _square_residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|x - y^2| with y^2 taken exactly as a float64 pair (Dekker)."""
    p = y * y
    c = 134217729.0 * y
    hi = c - (c - y)
    lo = y - hi
    return ((x - p) - (((hi * hi - p) + 2 * hi * lo) + lo * lo)).abs()


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """IEEE sqrt, correctly rounded as CUDA's and XLA's are: PyTorch's CPU
    sqrt is one ulp low on about 0.7% of float64 inputs, so each result
    moves to the neighbour whose square is nearer x, where there is one."""
    y = torch.sqrt(x)
    ok = torch.isfinite(y) & (y > 1e-150) & (y < 1e150)
    best, r = y, _square_residual(x, y)
    for to in (-np.inf, np.inf):
        cand = torch.nextafter(y, torch.full_like(y, to))
        rc = _square_residual(x, cand)
        better = ok & (rc < r)
        best = torch.where(better, cand, best)
        r = torch.where(better, rc, r)
    return best


_MATH_TORCH = (torch.abs, _sqrt_rn, torch.exp, torch.log, torch.log2,
               torch.log10, torch.sin, torch.cos, torch.tan, torch.floor,
               torch.ceil)
# the parts `date_part` lowers (lower.py:671-674), by id
DATE_PARTS = ("year", "quarter", "month", "day", "week", "doy", "dow",
              "epoch", "hour", "minute", "second", "millisecond",
              "microsecond", "nanosecond")
_PART_ID = {p: i for i, p in enumerate(DATE_PARTS)}
_US_PER_DAY = 86_400_000_000

MAX_STACK = 16    # the kernel's per-row stack depth

# the device dtypes (`DataType.device_dtype()`) a program computes in
_COL_DTYPES = {np.dtype(t) for t in (np.bool_, np.int32, np.int64,
                                     np.float32, np.float64)}


class LoweringError(Exception):
    pass


class AuxSpec:
    """One host-computed input of a program, recomputed per batch
    (same idea as `datafusion_tpu.device.lower.AuxSpec`)."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn          # batch -> np array of int64-convertible values
        self.name = name


class Pools:
    """Constants and aux inputs shared by every program of one aggregate."""

    def __init__(self):
        self.iconst: List[int] = []
        self.fconst: List[float] = []
        self.aux: List[AuxSpec] = []
        self.columns: Dict[int, np.dtype] = {}   # column index -> dtype

    def i(self, *vals) -> int:
        self.iconst.extend(int(v) for v in vals)
        return len(self.iconst) - len(vals)

    def f(self, *vals) -> int:
        self.fconst.extend(float(v) for v in vals)
        return len(self.fconst) - len(vals)

    def add_aux(self, fn, name) -> int:
        self.aux.append(AuxSpec(fn, name))
        return len(self.aux) - 1

    def aux_buffer(self, batch) -> np.ndarray:
        """Per-batch aux inputs as one int64 array: a header of
        (offset, length) per slot, then the data."""
        parts = [np.asarray(s.fn(batch)).astype(np.int64).ravel()
                 for s in self.aux]
        head = 2 * len(parts)
        out = np.zeros(head + sum(len(p) for p in parts), np.int64)
        off = head
        for j, p in enumerate(parts):
            out[2 * j], out[2 * j + 1] = off, len(p)
            out[off:off + len(p)] = p
            off += len(p)
        return out


class Program:
    """One compiled expression: a list of (op, a, b) over shared pools."""

    def __init__(self, code, pools: Pools, out_dtype: np.dtype):
        self.code: List[Tuple[int, int, int]] = code
        self.pools = pools
        self.out_dtype = np.dtype(out_dtype)   # the JAX package's dtype

    @property
    def is_float(self) -> bool:
        return self.out_dtype.kind == "f"


def compile_expr(e: PE.PhysicalExpr, pools: Optional[Pools] = None) -> Program:
    pools = pools if pools is not None else Pools()
    code: List[Tuple[int, int, int]] = []
    out = _Compiler(pools, code).emit(e)
    depth = _max_depth(code)
    if depth > MAX_STACK:
        raise LoweringError(f"expression needs stack depth {depth}")
    return Program(code, pools, out)


_PUSH = {OP_COL, OP_ICONST, OP_FCONST, OP_NULL, OP_ROWID, OP_AUX}
_BINARY = {OP_ADD_I, OP_SUB_I, OP_MUL_I, OP_ADD_F, OP_SUB_F, OP_MUL_F,
           OP_CMP_I, OP_CMP_F, OP_AND, OP_OR, OP_DIV_I, OP_MOD_I, OP_DIV_F,
           OP_MOD_F}


def _max_depth(code) -> int:
    sp = depth = 0
    for op, _a, _b in code:
        sp += 1 if op in _PUSH else (-1 if op in _BINARY else
                                     (-2 if op == OP_SELECT else 0))
        depth = max(depth, sp)
    return depth


def compile_key(e: PE.PhysicalExpr, pools: Pools) -> Program:
    """A group-key program: its value packs as an int64, so a float key
    (date_part's whole-number Float64, `_phys_int_bounds`) is truncated to
    one, as the reference's `kd.astype(jnp.int64)` does
    (`device_join_chain.py:1846`)."""
    prog = compile_expr(e, pools)
    if prog.is_float:
        prog.code.append((OP_F2I, 0, 0))
        prog.out_dtype = np.dtype(np.int64)
    return prog


def _dt(t) -> np.dtype:
    try:
        d = t.device_dtype()
    except NotImplementedError as err:
        raise LoweringError(str(err))
    if d not in _COL_DTYPES:
        raise LoweringError(f"type {t} has no device lane")
    return d


class _Compiler:
    def __init__(self, pools: Pools, code):
        self.p = pools
        self.code = code

    def op(self, op, a=0, b=0):
        self.code.append((op, int(a), int(b)))

    # JAX's `x.astype(to)` as program steps on the stack top
    def astype(self, frm: np.dtype, to: np.dtype):
        frm, to = np.dtype(frm), np.dtype(to)
        if frm == to:
            return
        if to.kind == "f":
            if frm.kind != "f":
                self.op(OP_I2F)
            if to.itemsize == 4:
                self.op(OP_F32)
            return
        if to.kind == "i":
            if frm.kind == "f":
                raise LoweringError("float to integer cast on device TBD")
            self.round_to(to)
            return
        raise LoweringError(f"cast {frm} -> {to} on device TBD")

    def round_to(self, d: np.dtype):
        """After an op computed in 64 bits: narrow to JAX's result dtype."""
        if d == np.float32:
            self.op(OP_F32)
        elif d == np.int32:
            self.op(OP_WRAP32)

    def emit(self, e) -> np.dtype:
        if isinstance(e, PE.ColumnExpr):
            t = e.out_type
            if t.is_wide_decimal or (t.is_interval and
                                     not (t.unit or "").startswith("rawdur")):
                raise LoweringError("object-storage column stays on host")
            d = _dt(t)
            prev = self.p.columns.setdefault(e.index, d)
            if prev != d:
                raise LoweringError("column read at two dtypes")
            self.op(OP_COL, e.index)
            return d

        if isinstance(e, PE.LiteralExpr):
            sv = e.value
            if sv.dtype.is_string:
                raise LoweringError("bare string literal outside comparison")
            d = _dt(sv.dtype)
            if sv.value is None:
                self.op(OP_NULL)
                return d
            v = sv.device_value()
            if d.kind == "f":
                self.op(OP_FCONST, self.p.f(v))
            else:
                self.op(OP_ICONST, self.p.i(v))
            return d

        if isinstance(e, PE.BinaryPhysExpr):
            return self.binary(e)

        if isinstance(e, PE.CastExpr):
            frm, to = e.expr.out_type, e.out_type
            if frm.is_string or to.is_string:
                raise LoweringError("string casts stay on host")
            if frm.is_decimal or to.is_decimal:
                if frm.is_decimal and to.is_decimal and frm.scale == to.scale:
                    return self.emit(e.expr)
                raise LoweringError("decimal rescale cast on device TBD")
            inner = self.emit(e.expr)
            to_d = _dt(to)
            self.astype(inner, to_d)
            return to_d

        if isinstance(e, PE.NotExpr):
            self.emit(e.expr)
            self.op(OP_NOT)
            return np.dtype(np.bool_)

        if isinstance(e, PE.NegativeExpr):
            d = self.emit(e.expr)
            self.op(OP_NEG_F if d.kind == "f" else OP_NEG_I)
            self.round_to(d)
            return d

        if isinstance(e, PE.IsNullExpr):
            self.emit(e.expr)
            self.op(OP_ISNOTNULL if e.negated else OP_ISNULL)
            return np.dtype(np.bool_)

        if isinstance(e, PE.InListExpr):
            return self.inlist(e)

        if isinstance(e, PE.LikeExpr):
            return self.like(e)

        if isinstance(e, PE.DeferredScalarExpr):
            return self.scalar_subquery(e)

        if isinstance(e, PE.CaseExpr):
            return self.case(e)

        if isinstance(e, PE.ScalarFunctionExpr):
            return self.function(e)

        raise LoweringError(f"cannot lower {type(e).__name__}")

    # -- uncorrelated scalar subquery (lower.py:98-114) ---------------------
    def scalar_subquery(self, e):
        if e.out_type.is_string:
            raise LoweringError("string scalar subquery on device TBD")
        d = _dt(e.out_type)

        def prep(batch, _e=e, _d=d):
            val, valid, _dic = _e.scalar()
            v = np.asarray(val).astype(_d)
            bits = v.astype(np.float64).view(np.int64) if _d.kind == "f" \
                else v.astype(np.int64)
            return np.array([bits, int(bool(valid))], np.int64)
        self.op(OP_AUX, self.p.add_aux(prep, "scalar_subquery"),
                int(d.kind == "f"))
        return d

    # -- searched CASE (lower.py:163-188) -----------------------------------
    def case(self, e):
        """ELSE (or NULL), then each WHEN from the last to the first as a
        select over the value so far, so the first WHEN whose condition is
        true and valid wins and the stack stays one entry deep between
        WHENs."""
        if e.operand is not None:
            raise LoweringError("CASE <operand> lowering TBD")
        out = _dt(e.out_type)
        if e.else_ is not None:
            self.astype(self.emit(e.else_), out)
        else:
            self.op(OP_NULL)
        for w, th in reversed(e.whens):
            self.emit(w)
            self.astype(self.emit(th), out)
            self.op(OP_SELECT)
        return out

    # -- the _MATH functions and date_part (lower.py:596-723) ---------------
    def function(self, e):
        if e.name in _MATH_ID and len(e.args) == 1:
            d = self.emit(e.args[0])
            if d.kind != "f":
                self.op(OP_I2F)
            self.op(OP_MATH, _MATH_ID[e.name])
            out = _dt(e.out_type)
            if out.kind == "f":
                self.round_to(out)
            elif out.kind == "i":
                self.op(OP_F2I)
                self.round_to(out)
            else:
                raise LoweringError(f"{e.name} to {out}")
            return out
        if e.name in ("date_part", "datepart") and len(e.args) == 2:
            return self.date_part(e)
        raise LoweringError(f"function {e.name} not lowerable")

    def date_part(self, e):
        from ..functions.datetime_impl import _PART_ALIASES, _TS_SCALE
        lit = e.args[0]
        if not isinstance(lit, PE.LiteralExpr) or lit.value.value is None:
            raise LoweringError("date_part needs a literal part")
        part = _PART_ALIASES.get(str(lit.value.value).lower())
        ct = e.args[1].out_type
        if getattr(ct, "tz", None):
            raise LoweringError("tz-aware date_part stays on host")
        if ct.id == TypeId.DATE:
            to_us = 1000 if ct.unit == "ms" else _US_PER_DAY
        elif ct.id == TypeId.TIMESTAMP:
            scale = _TS_SCALE[ct.unit]
            to_us = (10**6 // scale) if scale <= 10**6 else -(scale // 10**6)
        else:
            raise LoweringError("date_part needs a date/timestamp input")
        if part not in _PART_ID:
            raise LoweringError(f"date_part part '{part}' not lowerable")
        if self.emit(e.args[1]).kind == "f":
            raise LoweringError("float-backed temporal column")
        self.op(OP_DATEPART, _PART_ID[part], to_us)
        out = _dt(e.out_type)
        self.astype(np.dtype(np.float64), out)
        return out

    # -- string column <cmp> string literal (lower.py:228-270) -------------
    def strcmp(self, e, op):
        col, lit, flipped = None, None, False
        if isinstance(e.left, PE.ColumnExpr) and _strlit(e.right) is not None:
            col, lit = e.left, _strlit(e.right)
        elif isinstance(e.right, PE.ColumnExpr) and _strlit(e.left) is not None:
            col, lit, flipped = e.right, _strlit(e.left), True
        if col is None:
            raise LoweringError("string comparison needs column vs literal")
        if flipped:
            op = _FLIP.get(op, op)

        def prep(batch, _i=col.index, _s=lit):
            dic = batch.columns[_i].dictionary
            pos = int(np.searchsorted(dic.values.astype(str), _s, side="left"))
            return np.array([pos, dic.lookup(_s)], np.int64)
        slot = self.p.add_aux(prep, f"strlit:{lit}")
        self.emit(col)
        self.op(OP_STRCMP, _CMP[op], slot)
        return np.dtype(np.bool_)

    def binary(self, e):
        op = e.op
        lt, rt = e.left.out_type, e.right.out_type
        if op in _CMP and (lt.is_string or rt.is_string):
            return self.strcmp(e, op)

        # decimal <cmp> float literal: exact scaled-int thresholds computed
        # on the host (lower.py:278-321)
        if op in _CMP:
            dec = lit = None
            if lt.is_decimal and isinstance(e.right, PE.LiteralExpr) and \
                    rt.is_float and e.right.value.value is not None:
                dec, lit, op_ = e.left, e.right, op
            elif rt.is_decimal and isinstance(e.left, PE.LiteralExpr) and \
                    lt.is_float and e.left.value.value is not None:
                dec, lit, op_ = e.right, e.left, _FLIP.get(op, op)
            if dec is not None:
                t_ge, t_gt = _decimal_thresholds(
                    np.float64(lit.value.value), 10 ** dec.out_type.scale)
                inner = self.emit(dec)
                if inner.kind == "f":
                    raise LoweringError("float-backed decimal")
                self.op(OP_DECCMP, _CMP[op_], self.p.i(t_ge, t_gt))
                return np.dtype(np.bool_)

        # decimal <cmp> float scalar subquery: the same thresholds, computed
        # at every execution from the subquery's value (lower.py:323-377)
        if op in _CMP:
            dec = sc = None
            if lt.is_decimal and isinstance(e.right, PE.DeferredScalarExpr) \
                    and rt.is_float:
                dec, sc, op_ = e.left, e.right, op
            elif rt.is_decimal and isinstance(e.left, PE.DeferredScalarExpr) \
                    and lt.is_float:
                dec, sc, op_ = e.right, e.left, _FLIP.get(op, op)
            if dec is not None:
                def thresholds(_b, _s=sc, _scale=10 ** dec.out_type.scale):
                    val, valid, _dic = _s.scalar()
                    if not valid:
                        return np.zeros(3, np.int64)
                    t_ge, t_gt = _decimal_thresholds(np.float64(val), _scale)
                    return np.array([t_ge, t_gt, 1], np.int64)
                slot = self.p.add_aux(thresholds, "dec_scalar_thresholds")
                if self.emit(dec).kind == "f":
                    raise LoweringError("float-backed decimal")
                self.op(OP_DECCMP_AUX, _CMP[op_], slot)
                return np.dtype(np.bool_)

        if op in _CMP:
            common_t = K._comparison_type(lt, rt)
            common = _dt(common_t)
            self.conv(self.emit(e.left), lt, common_t, common)
            self.conv(self.emit(e.right), rt, common_t, common)
            self.op(OP_CMP_F if common.kind == "f" else OP_CMP_I, _CMP[op])
            return np.dtype(np.bool_)

        if op in (Op.AND, Op.OR):
            self.emit(e.left)
            self.emit(e.right)
            self.op(OP_AND if op == Op.AND else OP_OR)
            return np.dtype(np.bool_)

        if op in (Op.PLUS, Op.MINUS, Op.MULTIPLY, Op.DIVIDE, Op.MODULO):
            return self.arith(e)
        raise LoweringError(f"cannot lower operator {op}")

    def conv(self, d, frm, common_t, common):
        """`conv` of lower.py:393-413 on the stack top."""
        if frm.is_decimal and common_t.is_float:
            self.astype(d, common)
            self.op(OP_DIVC_F, self.p.f(10.0 ** frm.scale))
            self.round_to(common)
            return
        if frm.is_decimal and common_t.is_decimal:
            self.astype(d, np.int64)
            ds = common_t.scale - frm.scale
            if ds < 0:
                raise LoweringError("decimal downscale compare on device TBD")
            if ds:
                self.op(OP_MULC_I, self.p.i(10 ** ds))
            return
        if common_t.is_decimal:
            self.astype(d, np.int64)
            self.op(OP_MULC_I, self.p.i(10 ** common_t.scale))
            return
        if common_t.id in (TypeId.TIMESTAMP, TypeId.TIME) and \
                frm.id in (TypeId.TIMESTAMP, TypeId.TIME, TypeId.DATE):
            unit = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}
            fb = unit[common_t.unit or "ns"]
            fa = 86_400 * fb if frm.id == TypeId.DATE else unit[frm.unit or "ns"]
            if frm.id != TypeId.DATE and fb < fa:
                raise LoweringError("timestamp downscale compare on device TBD")
            self.astype(d, np.int64)
            self.op(OP_MULC_I, self.p.i(fa if frm.id == TypeId.DATE
                                        else fb // fa))
            return
        self.astype(d, common)

    def arith(self, e):
        """`+ - * / %` of lower.py:446-508, with the decimal rescale by
        10^k. Integer `/` truncates toward zero and `%` takes the sign of
        the dividend; for both, and for float `%`, a zero divisor is
        replaced by 1 and the row stays valid (`:498`, `:504`). Float `/`
        gives IEEE inf and NaN."""
        op, out_t = e.op, e.out_type
        lt, rt = e.left.out_type, e.right.out_type
        if op in (Op.DIVIDE, Op.MODULO) and out_t.is_decimal:
            raise LoweringError("decimal div/mod on device TBD")
        if lt.is_temporal or rt.is_temporal or lt.is_interval or rt.is_interval:
            raise LoweringError("temporal arithmetic on device TBD")
        npdt = _dt(out_t)
        scale_l = scale_r = 0
        if out_t.is_decimal:
            ls = lt.scale if lt.is_decimal else 0
            rs = rt.scale if rt.is_decimal else 0
            if op in (Op.PLUS, Op.MINUS):
                if ls > out_t.scale or rs > out_t.scale:
                    raise LoweringError("decimal downscale add on device TBD")
                scale_l, scale_r = out_t.scale - ls, out_t.scale - rs
            else:
                if ls + rs > out_t.scale:
                    raise LoweringError("decimal downscale mul on device TBD")
                scale_l = out_t.scale - ls - rs
        for side, t, scale in ((e.left, lt, scale_l), (e.right, rt, scale_r)):
            d = self.emit(side)
            if out_t.is_decimal:
                self.astype(d, np.int64)
                if scale:
                    self.op(OP_MULC_I, self.p.i(10 ** scale))
            else:
                self.astype(d, npdt)
                if t.is_decimal and out_t.is_float:
                    self.op(OP_DIVC_F, self.p.f(10.0 ** t.scale))
                    self.round_to(npdt)
        is_f = npdt.kind == "f"
        if op in (Op.DIVIDE, Op.MODULO):
            if is_f:
                self.op(OP_DIV_F if op == Op.DIVIDE else OP_MOD_F)
            elif npdt.kind == "i":
                self.op(OP_DIV_I if op == Op.DIVIDE else OP_MOD_I, 0,
                        8 * npdt.itemsize)
            else:
                raise LoweringError(f"{op} on {npdt}")
        else:
            base = {Op.PLUS: OP_ADD_I, Op.MINUS: OP_SUB_I,
                    Op.MULTIPLY: OP_MUL_I}[op]
            self.op(base + 3 if is_f else base)
        self.round_to(npdt)
        return npdt

    def inlist(self, e):
        col = e.expr if isinstance(e.expr, PE.ColumnExpr) else None
        if e.expr.out_type.is_string:
            if col is None:
                raise LoweringError("string IN needs a plain column")
            items = []
            for it in e.items:
                s = _strlit(it)
                if s is None:
                    raise LoweringError("string IN list must be literals")
                items.append(s)

            def prep(batch, _i=col.index, _items=tuple(items)):
                dic = batch.columns[_i].dictionary
                lut = np.zeros(max(len(dic), 1), bool)
                for s in _items:
                    code = dic.lookup(s)
                    if code >= 0:
                        lut[code] = True
                return lut
            self.emit(col)
            self.op(OP_LUT, self.p.add_aux(prep, "inlist_lut"))
        else:
            consts = []
            for it in e.items:
                if not isinstance(it, PE.LiteralExpr) or it.value.value is None:
                    raise LoweringError("IN list must be non-null literals")
                consts.append(it.value.cast(e.expr.out_type).device_value())
            d = self.emit(e.expr)
            if d.kind == "f":
                self.op(OP_IN_F, self.p.f(*consts), len(consts))
            else:
                self.op(OP_IN_I, self.p.i(*consts), len(consts))
        if e.negated:
            self.op(OP_NOT)
        return np.dtype(np.bool_)

    def like(self, e):
        col = e.expr if isinstance(e.expr, PE.ColumnExpr) else None
        pat = _strlit(e.pattern)
        if col is None or pat is None:
            raise LoweringError("LIKE needs column vs literal pattern")
        ci, esc = e.case_insensitive, e.escape

        def prep(batch, _i=col.index, _p=pat):
            import re
            dic = batch.columns[_i].dictionary
            flags = re.DOTALL | (re.IGNORECASE if ci else 0)
            rx = re.compile(K.like_pattern_to_regex(_p, esc), flags)
            lut = np.fromiter((rx.match(s) is not None for s in dic.values),
                              dtype=bool, count=len(dic))
            return lut if len(lut) else np.zeros(1, bool)
        self.emit(col)
        self.op(OP_LUT, self.p.add_aux(prep, f"like:{pat}"))
        if e.negated:
            self.op(OP_NOT)
        return np.dtype(np.bool_)


def _strlit(e) -> Optional[str]:
    if isinstance(e, PE.LiteralExpr) and e.value.dtype.is_string:
        return e.value.value
    return None


def _decimal_thresholds(lit: np.float64, scale: int):
    """(min s with f64(s/scale) >= lit, min s with f64(s/scale) > lit),
    scanned in host float64 as lower.py:296-303 does."""
    c = int(np.floor(float(lit) * scale)) - 2
    while np.float64(c) / np.float64(scale) < lit:
        c += 1
    c2 = c
    while np.float64(c2) / np.float64(scale) <= lit:
        c2 += 1
    return c, c2


# --- the plain PyTorch interpreter ------------------------------------------

def _cmp(code: int, a, b):
    return (torch.eq, torch.ne, torch.lt, torch.le, torch.gt,
            torch.ge)[code](a, b)


def _aux_slot(aux: torch.Tensor, j: int) -> torch.Tensor:
    off, n = int(aux[2 * j]), int(aux[2 * j + 1])
    return aux[off:off + n]


_I64_MIN = -(1 << 63)
_I32_MIN = -(1 << 31)


def _wneg(x: torch.Tensor, width: int) -> torch.Tensor:
    """-x in the operand's width: the width's minimum stays itself."""
    return torch.where(x == _I32_MIN, x, -x) if width == 32 else -x


def _wabs(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.where(x < 0, _wneg(x, width), x)


def _divmod(op: int, width: int, x: torch.Tensor, y: torch.Tensor):
    """`/` and `%` as the reference's device path computes them
    (lower.py:496-507) on operands of `width` bits held in int64: integer
    `/` is sign(x) sign(y) (|x| // |y|), `%` is x >= 0 ? x mod |y| :
    -((-x) mod |y|) with Python's floor `//` and `mod` and the width's
    wrapping `abs` and negation; a zero divisor counts as 1."""
    if op == OP_DIV_F:
        return x / y
    if op == OP_MOD_F:
        m = torch.where(y == 0, 1.0, y).abs()
        return torch.where(x >= 0, torch.fmod(x, m), -torch.fmod(-x, m))
    safe = torch.where(y == 0, 1, y)
    m = _wabs(safe, width)
    if op == OP_DIV_I:
        q = torch.div(_wabs(x, width), m, rounding_mode="floor")
        return torch.sign(x) * torch.sign(safe) * q
    return torch.where(x >= 0, torch.remainder(x, m),
                       _wneg(torch.remainder(_wneg(x, width), m), width))


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 toward zero; NaN gives 0, out-of-range values
    saturate."""
    big = float(1 << 63)
    inside = (x > -big) & (x < big)
    t = torch.where(inside, x, 0.0).to(torch.int64)
    t = torch.where(x >= big, (1 << 63) - 1, t)
    return torch.where(x <= -big, _I64_MIN, t)


def _fdiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _days_to_ymd(days: torch.Tensor):
    """Civil from days (Hinnant, lower.py:619-632), int64 floor steps."""
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    dom = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(torch.int64), m, dom


def _jan1(y: torch.Tensor) -> torch.Tensor:
    """Days from civil of (y, 1, 1) (lower.py:635-645 with m = d = 1)."""
    yy = y - 1
    era = _fdiv(yy, 400)
    yoe = yy - era * 400
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + 306
    return era * 146097 + doe - 719468


def _date_part(part: int, to_us: int, x: torch.Tensor) -> torch.Tensor:
    """`date_part` of lower.py:678-722 over raw date/timestamp values, as
    float64."""
    us = _fdiv(x, -to_us) if to_us < 0 else x * to_us
    days = _fdiv(us, _US_PER_DAY)
    within = us - days * _US_PER_DAY
    name = DATE_PARTS[part]
    if name == "epoch":
        return us.to(torch.float64) / 1e6
    if name in ("year", "quarter", "month", "day", "doy"):
        y, m, dom = _days_to_ymd(days)
        out = {"year": y, "quarter": _fdiv(m - 1, 3) + 1, "month": m,
               "day": dom}.get(name)
        if name == "doy":
            out = days - _jan1(y) + 1
    elif name == "week":             # ISO week: that of this week's Thursday
        thu = days - torch.remainder(days + 3, 7) + 3
        out = _fdiv(thu - _jan1(_days_to_ymd(thu)[0]), 7) + 1
    elif name == "dow":
        out = torch.remainder(days + 4, 7)
    elif name == "hour":
        out = _fdiv(within, 3_600_000_000)
    elif name == "minute":
        out = _fdiv(torch.remainder(within, 3_600_000_000), 60_000_000)
    elif name == "second":
        out = _fdiv(torch.remainder(within, 60_000_000), 1_000_000)
    elif name == "millisecond":
        out = _fdiv(torch.remainder(within, 60_000_000), 1000)
    elif name == "microsecond":
        out = torch.remainder(within, 60_000_000)
    else:                            # nanosecond
        out = torch.remainder(within, 60_000_000) * 1000
    return out.to(torch.float64)


def evaluate(prog: Program, cols: Dict[int, Tuple[torch.Tensor, Optional[torch.Tensor]]],
             aux: torch.Tensor, n: int):
    """Run `prog` over whole columns: returns (data, valid) tensors of
    length `n`, data int64 or float64 (bool results as int64 0/1), valid
    bool. `cols` maps column index -> (data, validity or None)."""
    p = prog.pools
    dev = aux.device
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    st: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def pop2():
        b = st.pop()
        a = st.pop()
        return a, b

    for op, a, b in prog.code:
        if op == OP_COL:
            data, valid = cols[a]
            data = data[:n]
            data = data.to(torch.float64) if data.is_floating_point() \
                else data.to(torch.int64)
            st.append((data, ones if valid is None else valid[:n]))
        elif op == OP_ICONST:
            st.append((torch.full((n,), p.iconst[a], dtype=torch.int64,
                                  device=dev), ones))
        elif op == OP_FCONST:
            st.append((torch.full((n,), p.fconst[a], dtype=torch.float64,
                                  device=dev), ones))
        elif op == OP_NULL:
            st.append((torch.zeros(n, dtype=torch.int64, device=dev),
                       torch.zeros(n, dtype=torch.bool, device=dev)))
        elif op in (OP_ADD_I, OP_SUB_I, OP_MUL_I, OP_ADD_F, OP_SUB_F,
                    OP_MUL_F):
            (x, xv), (y, yv) = pop2()
            k = (op - OP_ADD_I) % 3
            d = x + y if k == 0 else (x - y if k == 1 else x * y)
            st.append((d, xv & yv))
        elif op in (OP_NEG_I, OP_NEG_F):
            x, xv = st.pop()
            st.append((-x, xv))
        elif op == OP_MULC_I:
            x, xv = st.pop()
            st.append((x * p.iconst[a], xv))
        elif op == OP_DIVC_F:
            x, xv = st.pop()
            st.append((x / p.fconst[a], xv))
        elif op == OP_I2F:
            x, xv = st.pop()
            st.append((x.to(torch.float64), xv))
        elif op == OP_F32:
            x, xv = st.pop()
            st.append((x.to(torch.float32).to(torch.float64), xv))
        elif op == OP_WRAP32:
            x, xv = st.pop()
            st.append((x.to(torch.int32).to(torch.int64), xv))
        elif op in (OP_CMP_I, OP_CMP_F):
            (x, xv), (y, yv) = pop2()
            st.append((_cmp(a, x, y).to(torch.int64), xv & yv))
        elif op == OP_STRCMP:
            x, xv = st.pop()
            s = _aux_slot(aux, b)
            pos, exact = s[0], s[1]
            d = (x == exact, x != exact, x < pos, (x < pos) | (x == exact),
                 (x >= pos) & (x != exact), x >= pos)[a]
            st.append((d.to(torch.int64), xv))
        elif op == OP_DECCMP:
            x, xv = st.pop()
            t_ge, t_gt = p.iconst[b], p.iconst[b + 1]
            d = ((x >= t_ge) & (x < t_gt), (x < t_ge) | (x >= t_gt),
                 x < t_ge, x < t_gt, x >= t_gt, x >= t_ge)[a]
            st.append((d.to(torch.int64), xv))
        elif op == OP_LUT:
            x, xv = st.pop()
            lut = _aux_slot(aux, a)
            st.append((lut[x.clamp(0, lut.numel() - 1)], xv))
        elif op in (OP_IN_I, OP_IN_F):
            x, xv = st.pop()
            pool = p.iconst if op == OP_IN_I else p.fconst
            hit = torch.zeros(n, dtype=torch.bool, device=dev)
            for c in pool[a:a + b]:
                hit |= x == c
            st.append((hit.to(torch.int64), xv))
        elif op in (OP_AND, OP_OR):
            (x, xv), (y, yv) = pop2()
            x, y = x != 0, y != 0
            if op == OP_AND:
                d = (x | ~xv) & (y | ~yv)
                v = (xv & yv) | (xv & ~x) | (yv & ~y)
            else:
                tl, tr = xv & x, yv & y
                d, v = tl | tr, (xv & yv) | tl | tr
            st.append((d.to(torch.int64), v))
        elif op == OP_NOT:
            x, xv = st.pop()
            st.append(((x == 0).to(torch.int64), xv))
        elif op in (OP_ISNULL, OP_ISNOTNULL):
            _x, xv = st.pop()
            m = xv if op == OP_ISNOTNULL else ~xv
            st.append((m.to(torch.int64), ones))
        elif op in (OP_DIV_I, OP_MOD_I, OP_DIV_F, OP_MOD_F):
            (x, xv), (y, yv) = pop2()
            st.append((_divmod(op, b, x, y), xv & yv))
        elif op == OP_SELECT:
            (c, cv), (t, tv) = pop2()
            acc, av = st.pop()
            take = cv & (c != 0)
            st.append((torch.where(take, t, acc), torch.where(take, tv, av)))
        elif op == OP_MATH:
            x, xv = st.pop()
            st.append((_MATH_TORCH[a](x.to(torch.float64)), xv))
        elif op == OP_DATEPART:
            x, xv = st.pop()
            st.append((_date_part(a, b, x), xv))
        elif op == OP_ROWID:
            st.append((torch.arange(n, dtype=torch.int64, device=dev), ones))
        elif op == OP_AUX:
            s = _aux_slot(aux, a)
            d = s[0:1].clone()
            st.append(((d.view(torch.float64) if b else d).expand(n),
                       (s[1:2] != 0).expand(n)))
        elif op == OP_F2I:
            x, xv = st.pop()
            st.append((_f2i(x), xv))
        elif op == OP_DECCMP_AUX:
            x, xv = st.pop()
            s = _aux_slot(aux, b)
            t_ge, t_gt = s[0], s[1]
            d = ((x >= t_ge) & (x < t_gt), (x < t_ge) | (x >= t_gt),
                 x < t_ge, x < t_gt, x >= t_gt, x >= t_ge)[a]
            st.append((d.to(torch.int64), xv & (s[2] != 0)))
        else:
            raise ValueError(f"bad opcode {op}")
    (d, v), = st
    return d, v


# --- HAVING: programs over a grouped aggregate's output columns -------------
#
# Counterpart of `_apply_post_filter` (datafusion_tpu/physical/plan/
# device_aggregate.py:1279-1364). The predicate is an ordinary program; its
# column index i names output column i of the aggregate (keys, then
# aggregates). `device/groupby.py` finalises each such column from the group
# table (`HavingSpec`).

def check_having(pred: PE.PhysicalExpr, key_types, aggs) -> Program:
    """Compile a HAVING over an aggregate with keys of `key_types` and
    aggregates `aggs` (its output columns, in order), or raise
    LoweringError where the reference rule refuses
    (datafusion_tpu/physical/physical_optimizer.py:1304-1327): dictionary
    or string keys, aggregates other than count/sum/min/max/avg, decimal
    avg (it rounds in host bigint), any aux input."""
    n_keys = len(key_types)
    pools = Pools()
    prog = compile_expr(pred, pools)
    for i in pools.columns:
        if i < n_keys:
            t = key_types[i]
            if t.is_dict_coded or t.is_string:
                raise LoweringError("HAVING over a dictionary key")
            continue
        if i - n_keys >= len(aggs):
            raise LoweringError(f"HAVING reads column {i}")
        a = aggs[i - n_keys]
        if a.name not in ("count", "sum", "min", "max", "avg", "mean"):
            raise LoweringError(f"HAVING over {a.name}")
        if getattr(a, "distinct", False) and a.name != "count":
            raise LoweringError("HAVING over a DISTINCT aggregate")
        if a.name in ("avg", "mean") and a.out_type.is_decimal:
            raise LoweringError("HAVING over a decimal avg")
    if pools.aux:
        raise LoweringError("HAVING needs host aux inputs")
    return prog
