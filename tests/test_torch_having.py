"""The port's HAVING (kernel row 11) against the JAX package's
`_apply_post_filter`, on the CPU.

The port splits a HAVING into its top-level conjuncts and lays out each
that is one column tested against a constant (its constants folded by
`lower.fold_constants`), a column or an IN list in the join walk's
record form, which `csrc/compact_groups.cu` tests straight from the
finalised column; any other conjunct stays a program (`HavingSpec`).
`HavingSpec.mask`, the plain version `compact_groups_plain` runs, tests
the same conjuncts the same way; `HavingSpec.mode` says how the mark
tests them (inline, or a slot at a time with the interpreter for a
program conjunct). Each case builds the same numpy-seeded
table in both packages, folds the port's group table, and holds the
groups `compact_groups_plain` keeps to the groups the reference's
`_apply_post_filter` keeps on that table, and the conjunct layout to
the whole program's `evaluate`: every finaliser kind (an int key, a bool
key, a `date_part` float key, count, int, float64 and float32 sums, avg,
min and max with the NaN restore), a NULL aggregate, an IN list, two
direct conjuncts, a direct conjunct beside a program conjunct, and Q18's
decimal rescale, which must lay out as one CJ_CMP_I. The constant fold
is held to `evaluate` bit for bit (the interpreter's own `run` in
`test_torch_csrc_cpu.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import datafusion_tpu as df
from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column
from datafusion_tpu.common.schema import Field, Schema
from datafusion_tpu.physical.plan.device_aggregate import (
    DeviceGroupAggregateExec)
import datafusion_tpu_torch as dft
from datafusion_tpu_torch.device import groupby as G
from datafusion_tpu_torch.device import lower as L
from datafusion_tpu_torch.physical.plan.device_aggregate import (
    TorchGroupAggregateExec)
from test_torch_cuda import HAVING_CASES as CASES
from test_torch_cuda import HAVING_MODES, having_columns, having_sql
from torch_twin import twin

CPU = torch.device("cpu")


def having_batch(n: int = 6_000, seed: int = 5) -> Batch:
    """`test_torch_cuda.having_columns` as a batch of the JAX package."""
    cols = having_columns(n, seed)
    return Batch(Schema([Field(name, t(dt)) for name, t, _a, _v in cols]),
                 [Column(t(dt), a, v) for _n, t, a, v in cols], n)


def _port_exec(batch, sql):
    ctx = dft.SessionContext(CPU)
    pb = twin(batch)
    ctx.register_table("t", dft.MemTable(pb.schema, [[pb]]))
    node = ctx.sql(sql).create_physical_plan()
    while not isinstance(node, TorchGroupAggregateExec):
        node = node.children()[0]
    return ctx, node


def _ref_exec(batch, sql):
    ref = df.SessionContext()
    ref.register_table("t", df.MemTable(batch.schema, [[batch]]))
    node = ref.sql(sql).create_physical_plan()
    while type(node) is not DeviceGroupAggregateExec:
        node = node.children()[0]
    return node


def port_having(batch, sql):
    """(the port's exec, its HavingSpec, group table, spec, names, plan,
    slot map) of `sql` over `batch`."""
    ctx, ex = _port_exec(batch, sql)
    assert ex.post_filter is not None
    batches = ex.input_batches(ctx.task_context())
    spec, plan, names, slot_map = ex.compile(batches)
    table = ex.group_table(spec, batches, True)
    return ex, ex.having(spec, plan, names, slot_map), table, spec, names, \
        plan, slot_map


@pytest.fixture(scope="module")
def batch():
    return having_batch()


@pytest.mark.parametrize("case,forms,mode", CASES,
                         ids=[c for c, _f, _m in CASES])
def test_having_matches_apply_post_filter(batch, case, forms, mode):
    """The conjunct layout keeps the groups the reference keeps, and those
    the whole program keeps; its forms and the mark's mode are the
    expected ones."""
    sql = having_sql(case)
    _ex, hv, table, spec, names, plan, slot_map = port_having(batch, sql)
    assert [f.split("(")[0] for f in hv.forms] == forms, hv.forms
    assert hv.mode == HAVING_MODES[mode]
    got = G.compact_groups(table, hv).numpy()
    host = table.numpy()
    lanes = spec.lane_arrays(host, first=2)
    state = (jnp.asarray(host[0]), jnp.asarray(host[0] != G.EMPTY),
             {n: jnp.asarray(a) for n, a in zip(names, lanes)})
    _k, keep, _a = _ref_exec(batch, sql)._apply_post_filter(state, plan,
                                                            slot_map)
    np.testing.assert_array_equal(got, host[:, np.asarray(keep)])
    live = int((host[0] != G.EMPTY).sum())
    assert 0 < got.shape[1] < live
    n = table.shape[1]
    d, v = L.evaluate(hv.prog, G.finalise(table, hv.fins),
                      torch.zeros(0, dtype=torch.int64), n)
    assert torch.equal(hv.mask(table), (d != 0) & v)


def test_q18_having_is_one_cmp_i(batch):
    """TPC-H Q18's `sum(l_quantity) > 300` over a decimal(15, 2): the
    program rescales 300 by an OP_MULC_I; folded, it is one CJ_CMP_I on
    the sum's column against 30000, tested without the interpreter."""
    _ex, hv, *_ = port_having(batch, having_sql("k HAVING sum(q) > 300"))
    ops = [op for op, _a, _b in hv.prog.code]
    assert ops == [L.OP_COL, L.OP_ICONST, L.OP_MULC_I, L.OP_CMP_I]
    ((form, _prog),) = hv.conjuncts
    kind, col, code, const = form
    assert (kind, code, const) == (L.CJ_CMP_I, L.CMP_GT, 30000)
    assert hv.fins[col].kind == G.FIN_SUM
    assert hv.mode == G.HAVING_DIRECT


def _fold_programs():
    """(name, code, iconst, fconst): a constant and the unary steps the
    fold takes, at edges: int64 wraparound, int64 -> float64 rounding,
    float32 rounding, INT64_MIN negated, int32 wrap, -0.0, NaN, inf."""
    i64 = np.iinfo(np.int64)
    return [
        ("mulc wraps", [(L.OP_ICONST, 0, 0), (L.OP_MULC_I, 1, 0)],
         [i64.max, 3], []),
        ("mulc twice", [(L.OP_ICONST, 0, 0), (L.OP_MULC_I, 1, 0),
                        (L.OP_MULC_I, 2, 0)], [300, 100, -7], []),
        ("i2f rounds", [(L.OP_ICONST, 0, 0), (L.OP_I2F, 0, 0)],
         [(1 << 53) + 1], []),
        ("i2f of min", [(L.OP_ICONST, 0, 0), (L.OP_I2F, 0, 0)],
         [i64.min], []),
        ("mulc then i2f", [(L.OP_ICONST, 0, 0), (L.OP_MULC_I, 1, 0),
                           (L.OP_I2F, 0, 0)], [i64.max // 2 + 5, 2], []),
        ("neg of min", [(L.OP_ICONST, 0, 0), (L.OP_NEG_I, 0, 0)],
         [i64.min], []),
        ("wrap32", [(L.OP_ICONST, 0, 0), (L.OP_WRAP32, 0, 0)],
         [(1 << 31) + 7], []),
        ("f32 rounds", [(L.OP_FCONST, 0, 0), (L.OP_F32, 0, 0)], [], [0.1]),
        ("f32 overflows", [(L.OP_FCONST, 0, 0), (L.OP_F32, 0, 0)], [],
         [1e300]),
        ("neg of zero", [(L.OP_FCONST, 0, 0), (L.OP_NEG_F, 0, 0)], [],
         [0.0]),
        ("divc", [(L.OP_FCONST, 0, 0), (L.OP_DIVC_F, 1, 0)], [],
         [1.0, 3.0]),
        ("divc by zero", [(L.OP_FCONST, 0, 0), (L.OP_DIVC_F, 1, 0)], [],
         [-1.0, 0.0]),
        ("nan", [(L.OP_FCONST, 0, 0), (L.OP_F32, 0, 0),
                 (L.OP_NEG_F, 0, 0)], [], [float("nan")]),
    ]


def fold_case(name):
    """The program of fold case `name` and its folded form."""
    _n, code, ic, fc = next(c for c in _fold_programs() if c[0] == name)
    pools = L.Pools()
    pools.i(*ic)
    pools.f(*fc)
    is_f = code[-1][0] in (L.OP_I2F, L.OP_F32, L.OP_NEG_F, L.OP_DIVC_F)
    prog = L.Program(list(code), pools,
                     np.dtype(np.float64 if is_f else np.int64))
    return prog, L.fold_constants(prog)


FOLDS = [c[0] for c in _fold_programs()]


@pytest.mark.parametrize("name", FOLDS)
def test_fold_matches_evaluate_bit_for_bit(name):
    """A folded constant is one push holding the value `evaluate` gives
    the steps it replaces, bit for bit."""
    prog, folded = fold_case(name)
    assert len(folded.code) == 1
    empty = torch.zeros(0, dtype=torch.int64)
    (a, av), (b, bv) = (L.evaluate(p, {}, empty, 1) for p in (prog, folded))
    assert bool(av) and bool(bv)
    bits = (lambda t: t.view(torch.int64)) if a.is_floating_point() \
        else (lambda t: t)
    assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def test_fold_leaves_other_programs():
    """A constant under a binary step, or a column under a unary one, stays
    as it is."""
    pools = L.Pools()
    pools.i(5, 7)
    code = [(L.OP_COL, 0, 0), (L.OP_MULC_I, 0, 0), (L.OP_ICONST, 1, 0),
            (L.OP_ICONST, 0, 0), (L.OP_ADD_I, 0, 0), (L.OP_CMP_I, 4, 0)]
    prog = L.Program(code, pools, np.dtype(np.bool_))
    assert L.fold_constants(prog).code == code


def test_having_spec_is_reused_across_runs(batch):
    """A second lowering of the same HAVING on the same exec gets the first
    `HavingSpec` back, and with it its one copy of the descriptor on a
    device; a HAVING that lays out otherwise gets a spec of its own. The
    query's rows are the same on every run."""
    sql = having_sql("k HAVING sum(q) > 300")
    ctx, ex = _port_exec(batch, sql)
    batches = ex.input_batches(ctx.task_context())
    spec, plan, names, slot_map = ex.compile(batches)
    first = ex.having(spec, plan, names, slot_map)
    meta = first.device_meta(CPU)
    again = ex.having(*ex.compile(batches))
    assert again is first and again.device_meta(CPU) is meta
    runs = [ctx.sql(sql).collect_batch() for _ in range(2)]
    assert runs[0].num_rows == runs[1].num_rows > 0
    assert ex.having(spec, plan, names, slot_map) is first
    _ctx, other = _port_exec(batch, having_sql("k HAVING sum(q) > 301"))
    other._having_spec = first
    moved = other.having(*other.compile(other.input_batches(
        _ctx.task_context())))
    assert moved is not first and not np.array_equal(moved.meta, first.meta)
