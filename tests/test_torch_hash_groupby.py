"""The port's hash group aggregate, HAVING compaction and top-k against
the JAX package's grouping programs.

The JAX side runs on the CPU backend: `DeviceGroupAggregateExec._make_step`
(`prepare`: filter, key packing, value lanes) feeding each of the
reference's grouping routes above 64 slots — the sort path
(`device_group_aggregate`), the pre-sorted path (`_sorted_group_aggregate`),
the row-space pair (`rowspace_group_state` + `rowspace_group_emit`), the
unbounded path (`device_group_aggregate_big`) and the merge of two partial
tables (`_merge`) — and the reference's `_apply_post_filter` and
`_emit_topk`. The port side is `hash_group_aggregate` + `compact_groups`
(+ `group_topk`) on CPU tensors, which run their plain PyTorch versions.
Both get the same numpy-seeded columns; results compare as key -> lanes
maps. Counts, integer lanes and min/max (NaN included) must be equal.
Float64 sums agree within rel 1e-9 and abs 1e-6: the JAX routes take
them as differences of one running sum. Float32 sums are held against a
float64 numpy oracle: the port's per-group float32 adds within abs 1e-3,
the JAX routes' differences of one float32 running sum within abs 0.5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.common import dt
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column, Dictionary
from datafusion_tpu.common.scalar import ScalarValue
from datafusion_tpu.device.groupby import (
    _sorted_group_aggregate, device_group_aggregate,
    device_group_aggregate_big, rowspace_group_emit, rowspace_group_state)
from datafusion_tpu.device.lower import lower_expr
from datafusion_tpu.expr.operator import Op
from datafusion_tpu.physical.expressions import (BinaryPhysExpr, ColumnExpr,
                                                 LiteralExpr)
from datafusion_tpu.physical.plan.device_aggregate import (
    DeviceGroupAggregateExec, _PackPlan)
from datafusion_tpu_torch.common.column import to_device
from datafusion_tpu_torch.device import groupby as G
from datafusion_tpu_torch.device.lower import Pools, compile_expr
from torch_twin import twin

CPU = torch.device("cpu")
K = ColumnExpr(0, "k", dt.INT64)            # int key, NULLs
S = ColumnExpr(1, "s", dt.STRING)           # 3-value dictionary key
X = ColumnExpr(2, "x", dt.INT64)            # int lane, NULLs
V = ColumnExpr(3, "v", dt.FLOAT64)          # float lane, NULLs and NaNs
F = ColumnExpr(4, "f", dt.FLOAT32)          # float32 lane
W = ColumnExpr(5, "w", dt.FLOAT64)          # float lane, NULLs, no NaN
# (a NaN in a float sum turns every later group of the JAX routes' one
# running sum into NaN, so float sums read W)
SLOTS = [("v0#c", "cnt", X), ("v1#s", "sum", X), ("v2#n", "min", X),
         ("v3#x", "max", X), ("v4#c", "cnt", V), ("v5#s", "sum", W),
         ("v6#n", "min", V), ("v7#x", "max", V), ("v8#nn", "nancnt", V),
         ("v9#c", "cnt", None), ("v10#s", "sum", F), ("v11#c", "cnt", F),
         ("v12#c", "cnt", W)]
# the routes that take sums and counts only
SUM_SLOTS = [s for s in SLOTS if s[1] in ("sum", "cnt", "nancnt")]
# key width -> (offset, bits) of k: 6,001 values (the packed key is the
# slot) or values up to 2^40 (a probed hash table)
KEYS = {"narrow": (-3000, 13), "wide": (-1, 42)}


def _batch(n, seed, width, sorted_keys=False):
    rng = np.random.default_rng(seed)
    if width == "narrow":
        k = rng.integers(-3000, 3001, n)
    else:
        k = rng.integers(0, n // 4, n) * (1 << 40) // (n // 4)
    kv = rng.random(n) > 0.05
    if sorted_keys:
        k, kv = np.sort(k), np.ones(n, bool)
    v = rng.normal(size=n) * 1e3
    v[rng.random(n) < 0.05] = np.nan
    dic = Dictionary(np.array(["a", "b", "c"], dtype=object))
    return Batch(None, [
        Column(dt.INT64, k, kv),
        Column(dt.STRING, rng.integers(0, 3, n).astype(np.int32), None, dic),
        Column(dt.INT64, rng.integers(-10**12, 10**12, n),
               rng.random(n) > 0.2),
        Column(dt.FLOAT64, v, rng.random(n) > 0.1),
        Column(dt.FLOAT32, (rng.normal(size=n) * 10).astype(np.float32)),
        Column(dt.FLOAT64, rng.normal(size=n) * 1e3, rng.random(n) > 0.1),
    ], n)


def _pred(kind):
    if kind is None:
        return None
    zero = LiteralExpr(ScalarValue(dt.INT64, 0))
    return BinaryPhysExpr(X, Op.GT, zero, dt.BOOL)


def _plan(batch, width, both=True):
    """Keys k (low bits) and s, or k alone."""
    off, bits = KEYS[width]
    if not both:
        return _PackPlan([off], [bits], [K.out_type], [None])
    return _PackPlan([off, 0], [bits, 3], [K.out_type, S.out_type],
                     [None, batch.columns[1].dictionary])


def _prepare(batch, pred, width, slots, both=True):
    """JAX's `prepare` on the CPU backend: packed keys, row validity and
    the value arrays of each slot, with the slot kinds."""
    n = batch.num_rows
    pred_l = lower_expr(pred) if pred is not None else None
    key_l = [lower_expr(K), lower_expr(S)][:2 if both else 1]
    slot_defs = {name: (cat, lower_expr(e) if e is not None else None)
                 for name, cat, e in slots}
    lowereds = ([pred_l] if pred_l is not None else []) + key_l + \
        [low for _c, low in slot_defs.values() if low is not None]
    aux_offset, off = {}, 0
    for low in lowereds:
        aux_offset[id(low)] = off
        off += len(low.aux)
    null_layout = tuple(c.has_nulls for c in batch.columns)
    step = DeviceGroupAggregateExec._make_step(
        None, pred_l, key_l, slot_defs, _plan(batch, width, both), jnp,
        1 << 16,
        aux_offset, False, null_layout, n)
    cols = tuple(jnp.asarray(c.data_host()) for c in batch.columns)
    valids = tuple(jnp.asarray(c.validity_host()) for c in batch.columns
                   if c.has_nulls)
    packed, row_valid, arrs = step.prepare(cols, valids, np.int64(n),
                                           np.int64(0), ())
    return packed, row_valid, {s: (step.kinds[s], a) for s, a in arrs.items()}


def _jax_map(keys, valid, out):
    keys, valid = np.asarray(keys), np.asarray(valid)
    return {int(k): {s: np.asarray(a)[i] for s, a in out.items()}
            for i, k in enumerate(keys) if valid[i]}


def _spec(batch, pred, width, slots, rows, both=True):
    """The port's spec, compiled from the twins (its own classes) of the
    JAX package's expressions."""
    pools = Pools()
    pred_p = compile_expr(twin(pred), pools) if pred is not None else None
    off, bits = KEYS[width]
    keys = [(compile_expr(twin(K), pools), off, bits),
            (compile_expr(twin(S), pools), 0, 3)][:2 if both else 1]
    lanes = []
    for _name, cat, e in slots:
        prog = compile_expr(twin(e), pools) if e is not None else None
        lanes.append((prog, G.lane_kind(cat, prog, f32_sums=True)))
    return G.HashSpec(pools, pred_p, keys, lanes, rows)


def _fold(spec, batches, table=None):
    table = spec.new_table(CPU) if table is None else table
    overflow = torch.zeros(1, dtype=torch.int32)
    for b in batches:
        cols = {i: to_device(b.columns[i], CPU) for i in spec.pools.columns}
        aux = torch.from_numpy(spec.pools.aux_buffer(b))
        G.hash_group_aggregate(spec, cols, aux, b.num_rows, table, overflow)
    assert int(overflow) == 0
    return table


def _port_map(spec, slots, table):
    host = G.compact_groups(table).numpy()
    lanes = spec.lane_arrays(host, first=2)
    return {int(k): {name: lanes[j][i] for j, (name, _c, _e)
                     in enumerate(slots)}
            for i, k in enumerate(host[0])}, host


def _oracle_f32(f, keys_np, pred_valid):
    """float64 numpy sums of the float32 column f per packed key."""
    uk, inv = np.unique(keys_np[pred_valid], return_inverse=True)
    sums = np.zeros(len(uk))
    np.add.at(sums, inv, f[pred_valid].astype(np.float64))
    return dict(zip(uk.tolist(), sums))


def _assert_maps(port, jax_, slots, f32_oracle, jax_f32_atol=0.5):
    assert port.keys() == jax_.keys()
    keys = sorted(port)
    for name, cat, e in slots:
        got = np.array([port[k][name] for k in keys])
        want = np.array([jax_[k][name] for k in keys])
        if e is F and cat == "sum":
            oracle = np.array([f32_oracle[k] for k in keys])
            np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-3,
                                       err_msg=name)
            np.testing.assert_allclose(want, oracle, rtol=0,
                                       atol=jax_f32_atol, err_msg=name)
        elif e is W and cat == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-6,
                                       equal_nan=True, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("pred", [None, "x > 0"])
def test_hash_matches_sort_path(width, pred):
    """`device_group_aggregate`'s sort path: NULL keys, NaN min/max."""
    batch = _batch(20_000, 0, width)
    p = _pred(pred)
    packed, row_valid, values = _prepare(batch, p, width, SLOTS)
    gk, gv, out, _ng = device_group_aggregate(packed, row_valid, values,
                                              1 << 16)
    spec = _spec(batch, p, width, SLOTS, batch.num_rows)
    assert spec.identity_slots == (width == "narrow")
    port, _host = _port_map(spec, SLOTS, _fold(spec, [batch]))
    _assert_maps(port, _jax_map(gk, gv, out), SLOTS,
                 _oracle_f32(batch.columns[4].data_host(), np.asarray(packed),
                             np.asarray(row_valid)))


@pytest.mark.parametrize("route", ["sorted", "rowspace"])
def test_hash_matches_sorted_and_rowspace_paths(route):
    """One pre-sorted key column: `_sorted_group_aggregate`, and the
    row-space pair that the reference runs for one batch of sums and
    counts."""
    batch = _batch(20_000, 1, "narrow", sorted_keys=True)
    p = _pred("x > 0")
    packed, row_valid, values = _prepare(batch, p, "narrow", SUM_SLOTS,
                                         both=False)
    if route == "sorted":
        gk, gv, out, _ng = _sorted_group_aggregate(packed, row_valid, values,
                                                   1 << 16)
    else:
        lanes, ng = rowspace_group_state(packed, row_valid, values)
        kinds = {s: k for s, (k, _a) in values.items()}
        gk, gv, out, _ng = rowspace_group_emit(lanes, kinds, int(ng) + 1)
    spec = _spec(batch, p, "narrow", SUM_SLOTS, batch.num_rows, both=False)
    port, _host = _port_map(spec, SUM_SLOTS, _fold(spec, [batch]))
    _assert_maps(port, _jax_map(gk, gv, out), SUM_SLOTS,
                 _oracle_f32(batch.columns[4].data_host(), np.asarray(packed),
                             np.asarray(row_valid)))


def test_hash_matches_unbounded_path():
    """`device_group_aggregate_big`: results at the run ends of one sort."""
    batch = _batch(20_000, 2, "wide")
    packed, row_valid, values = _prepare(batch, None, "wide", SLOTS)
    values = {s: ({"count": "cnt"}.get(k, k), a)
              for s, (k, a) in values.items()}
    gk, is_end, out = device_group_aggregate_big(packed, row_valid, values)
    spec = _spec(batch, None, "wide", SLOTS, batch.num_rows)
    port, _host = _port_map(spec, SLOTS, _fold(spec, [batch]))
    _assert_maps(port, _jax_map(gk, is_end, out), SLOTS,
                 _oracle_f32(batch.columns[4].data_host(), np.asarray(packed),
                             np.asarray(row_valid)))


@pytest.mark.parametrize("width", ["narrow", "wide"])
def test_two_batches_fold_like_merge(width):
    """The reference aggregates each chunk and `_merge`s the partial
    tables; the port folds both batches into one table."""
    a, b = _batch(9_000, 3, width), _batch(11_000, 4, width)
    parts, packs = [], []
    for part in (a, b):
        packed, row_valid, values = _prepare(part, None, width, SLOTS)
        parts.append(device_group_aggregate(packed, row_valid, values,
                                            1 << 16)[:3])
        packs.append((np.asarray(packed), np.asarray(row_valid)))
    gk, gv, out = DeviceGroupAggregateExec._merge(None, parts[0], parts[1],
                                                  jnp, 1 << 16)
    spec = _spec(a, None, width, SLOTS, a.num_rows + b.num_rows)
    port, _host = _port_map(spec, SLOTS, _fold(spec, [a, b]))
    oracle = _oracle_f32(
        np.concatenate([a.columns[4].data_host(), b.columns[4].data_host()]),
        np.concatenate([packs[0][0], packs[1][0]]),
        np.concatenate([packs[0][1], packs[1][1]]))
    _assert_maps(port, _jax_map(gk, gv, out), SLOTS, oracle)


def test_descriptor_sections_line_up():
    """The descriptor's section offsets follow from the section sizes: the
    lane section ends the descriptor, 2 words a lane."""
    batch = _batch(100, 5, "wide")
    spec = _spec(batch, _pred("x > 0"), "wide", SLOTS, 100)
    meta = spec.meta
    progs = spec.programs()
    assert meta[G.H_OFF_CODE] - meta[G.H_OFF_PROGS] == 2 * len(progs)
    assert meta[G.H_OFF_ICONST] - meta[G.H_OFF_CODE] == \
        3 * sum(len(p.code) for p in progs)
    assert meta[G.H_OFF_LANES] - meta[G.H_OFF_KEYS] == 3 * len(spec.keys)
    assert len(meta) - meta[G.H_OFF_LANES] == 2 * len(spec.lanes)
    assert meta[G.H_G] == spec.cap


def test_plain_hash_table_overflow_is_flagged():
    batch = _batch(2_000, 6, "wide")
    spec = _spec(batch, None, "wide", SLOTS, 100)   # room for 256 keys
    table = spec.new_table(CPU)
    overflow = torch.zeros(1, dtype=torch.int32)
    cols = {i: to_device(batch.columns[i], CPU) for i in spec.pools.columns}
    aux = torch.from_numpy(spec.pools.aux_buffer(batch))
    G.hash_group_aggregate(spec, cols, aux, batch.num_rows, table, overflow)
    assert int(overflow) == 1
    assert int((table[0] != G.EMPTY).sum()) == spec.cap


# --- HAVING and top-k, through the SQL front end of both packages ----------

def _pair(data):
    import datafusion_tpu_torch as dft
    port = dft.SessionContext(CPU)
    port.register_arrays("t", data)
    return port


def _ref_exec(data, q):
    """The JAX package's DeviceGroupAggregateExec for `q` over `data`."""
    import datafusion_tpu as df
    ref = df.SessionContext()
    ref.register_arrays("t", data)
    node = ref.sql(q).create_physical_plan()
    while type(node) is not DeviceGroupAggregateExec:
        node = node.children()[0]
    return node


def _port_exec(ctx, q):
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    node = ctx.sql(q).create_physical_plan()
    while not isinstance(node, TorchGroupAggregateExec):
        node = node.children()[0]
    return node


def _table_data(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n) * 100
    v[rng.random(n) < 0.05] = np.nan
    return {"k": rng.integers(0, n // 3, n) * 1_000_003,
            "x": rng.integers(-1000, 1000, n),
            "v": v,
            "d": rng.integers(0, 11, n) / 100.0}


def _group_table(ex, ctx):
    batches = ex.input_batches(ctx.task_context())
    spec, plan, names, slot_map = ex.compile(batches)
    return spec, plan, names, slot_map, ex.group_table(spec, batches, True)


@pytest.mark.parametrize("having", [
    "sum(x) > 500",
    "count(*) >= 3 AND (min(v) < -50 OR max(v) IS NULL)",
    "avg(v) > 10 OR k < 3000009",
    "max(v) > 0 AND NOT (count(x) = 2)",
])
def test_having_compaction_matches_apply_post_filter(having):
    """The port's HAVING program over the group table keeps the groups
    that the reference's `_apply_post_filter` keeps, on the same table."""
    data = _table_data(6_000, 7)
    ctx = _pair(data)
    q = (f"SELECT k, sum(x) s, count(*) c, count(x) cx, min(v) mn, "
         f"max(v) mx, avg(v) a FROM t GROUP BY k HAVING {having}")
    ex = _port_exec(ctx, q)
    assert ex.post_filter is not None
    spec, plan, names, slot_map, table = _group_table(ex, ctx)
    hv = ex.having(spec, plan, names, slot_map)
    got = G.compact_groups(table, hv).numpy()
    host = table.numpy()
    lanes = spec.lane_arrays(host, first=2)
    state = (jnp.asarray(host[0]), jnp.asarray(host[0] != G.EMPTY),
             {n: jnp.asarray(a) for n, a in zip(names, lanes)})
    _k, keep, _a = _ref_exec(data, q)._apply_post_filter(state, plan,
                                                          slot_map)
    np.testing.assert_array_equal(got, host[:, np.asarray(keep)])
    assert 0 < got.shape[1] < int((host[0] != G.EMPTY).sum())


@pytest.mark.parametrize("asc", [False, True])
@pytest.mark.parametrize("k", [1, 10, 700, 5000])
def test_topk_matches_emit_topk(asc, k):
    """`group_topk` + `compact_groups` against the reference's `_emit_topk`
    (lax.top_k) on the same table. Ties at the k-th count may keep other
    groups: the counts must be equal, and the groups beyond the k-th."""
    data = _table_data(6_000, 8)
    ctx = _pair(data)
    q = (f"SELECT k, count(*) c, sum(x) s FROM t GROUP BY k "
         f"ORDER BY c {'ASC' if asc else 'DESC'} LIMIT {k}")
    ex = _port_exec(ctx, q)
    assert ex.topk == (0, asc, k)
    spec, plan, names, slot_map, table = _group_table(ex, ctx)
    lane, _asc, _k = ex._topk_lane(slot_map)
    slots = G.group_topk(table, 2 + names.index(lane), asc, k)
    host = G.compact_groups(table, slots=slots).numpy()
    got = ex._emit_arrays(host[0], np.ones(host.shape[1], bool),
                          dict(zip(names, spec.lane_arrays(host, first=2))),
                          plan, slot_map, None)
    full = table.numpy()
    valid = full[0] != G.EMPTY
    want = _ref_exec(data, q)._emit_topk(
        jnp.asarray(full[0]), jnp.asarray(valid),
        {n: jnp.asarray(a) for n, a in
         zip(names, spec.lane_arrays(full, first=2))},
        (lane, asc, k), plan, slot_map, None)
    gk, gc = (c.data_host() for c in got.columns[:2])
    wk, wc = (c.data_host() for c in want.columns[:2])
    assert got.num_rows == want.num_rows == min(k, int(valid.sum()))
    np.testing.assert_array_equal(np.sort(gc), np.sort(wc))
    kth = np.sort(wc)[-1] if asc else np.sort(wc)[0]
    beyond = (lambda key, c: key[c < kth]) if asc else \
        (lambda key, c: key[c > kth])
    np.testing.assert_array_equal(np.sort(beyond(gk, gc)),
                                  np.sort(beyond(wk, wc)))


def test_kernel_digest_covers_shared_headers(tmp_path):
    """An edit to a shared header (`csrc/*.cuh`) must rebuild the library:
    it changes the digest, though it is not compiled on its own."""
    from datafusion_tpu_torch import kernels
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    sources, before = kernels._inputs(tmp_path)
    (tmp_path / "h.cuh").write_text("// two\n")
    assert [s.name for s in sources] == ["k.cu"]
    assert kernels._inputs(tmp_path)[1] != before
    assert [s.name for s in kernels._inputs(kernels.CSRC)[0]] == [
        "chain_aggregate.cu", "chain_build.cu", "chain_rows.cu",
        "compact_groups.cu", "fused_dense_aggregate.cu", "gather_lanes.cu",
        "group_emit.cu", "group_topk.cu", "hash_group_aggregate.cu",
        "radix_sort.cu", "window_scan.cu"]
