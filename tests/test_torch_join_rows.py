"""Row-returning join chains, the resident group emit and the
count-over-LEFT-join rewrite through the port on the CPU, against the JAX
package.

`datafusion_tpu_torch.SessionContext(torch.device("cpu"))` runs the plain
PyTorch versions of `chain_build`, `chain_rows` and `group_emit_columns`;
the JAX package runs `DeviceJoinChainRowsExec` and
`_emit_device_resident` on the CPU backend, as its own tests do. Both
sessions set `datafusion.tpu.device_join_rows_min_spine` to 1, so the
small tables here take the row-returning chain. Each package registers
the same seeded numpy arrays with its own classes. Rows must be equal
(row order only under ORDER BY): integers, decimals, dates and strings
exactly, floats within rel 1e-9.
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.common import dt as ref_dt
from datafusion_tpu.physical.plan.aggregate import (
    LeftCountZeroFillExec as RefLeftCountZeroFillExec)
from datafusion_tpu.physical.plan.device_aggregate import (
    DeviceGroupAggregateExec)
from datafusion_tpu.physical.plan.device_join_chain import (
    DeviceJoinChainRowsExec)
from datafusion_tpu.tpch.queries import QUERIES as TPCH
from datafusion_tpu_torch.common.column import (Column, DeviceColumnCache,
                                                to_device)
from datafusion_tpu_torch.common import dt
from datafusion_tpu_torch.device.groupby import (
    EMIT_COUNT, EMIT_DICT, EMIT_KEY, EMIT_SUM, EmitField,
    group_emit_columns, group_emit_columns_plain)
from datafusion_tpu_torch.device.join_chain import chain_rows, chain_rows_plain
from datafusion_tpu_torch.physical.plan.aggregate import LeftCountZeroFillExec
from datafusion_tpu_torch.physical.plan.device_aggregate import (
    RESIDENT_EMIT_MIN_GROUPS, TorchGroupAggregateExec)
from datafusion_tpu_torch.physical.plan.device_join_chain import (
    TorchJoinChainRowsExec)
from torch_twin import register_both, register_tpch_both, twin

CPU = torch.device("cpu")
ROWS_ON = "SET datafusion.tpu.device_join_rows_min_spine = 1"


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _execs(ctx, q, cls):
    return [n for n in _walk(ctx.sql(q).create_physical_plan())
            if type(n) is cls]


def _same_value(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == pytest.approx(b, rel=1e-9, abs=1e-12, nan_ok=True)
    return a == b and type(a) is type(b)


def _same_rows(got, want, ordered):
    assert list(got) == list(want)
    g = list(zip(*got.values()))
    w = list(zip(*want.values()))
    assert len(g) == len(w)
    if not ordered:
        key = lambda r: tuple((x is None, str(x)) for x in r)  # noqa: E731
        g, w = sorted(g, key=key), sorted(w, key=key)
    for rg, rw in zip(g, w):
        assert all(_same_value(a, b) for a, b in zip(rg, rw)), (rg, rw)


def _sessions():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for c in (port, ref):
        c.sql(ROWS_ON)
    return port, ref


# --- TPC-H Q2, Q13 and Q20 at SF 0.01 -----------------------------------------

@pytest.fixture(scope="module")
def tpch():
    port, ref = _sessions()
    register_tpch_both(port, ref, sf=0.01, seed=1)
    return port, ref


@pytest.mark.parametrize("q", [2, 20])
def test_tpch_rows_chain_matches_jax_package(tpch, q):
    """Q2 (a 5-hop chain over partsupp with the subquery's min as a build
    and a decimal residual equality) and Q20 (an INNER hop on a composite
    key into the sum(l_quantity) aggregate and a SEMI hop into part, under
    a host join over supplier) return the JAX package's rows through the
    row-returning chain."""
    port, ref = tpch
    sql = TPCH[q]
    got, want = port.sql(sql).to_pydict(), ref.sql(sql).to_pydict()
    assert len(next(iter(got.values()))) > 0
    _same_rows(got, want, ordered=True)
    ref_rows = _execs(ref, sql, DeviceJoinChainRowsExec)
    port_rows = _execs(port, sql, TorchJoinChainRowsExec)
    assert len(port_rows) == len(ref_rows) >= 1
    assert all(e.fallbacks == 0 for e in port_rows)


def test_q13_left_count_matches_jax_package(tpch):
    """Q13's count over customer LEFT JOIN orders plans
    LeftCountZeroFillExec over a device aggregate of orders in both
    packages, with equal rows."""
    port, ref = tpch
    sql = TPCH[13]
    got, want = port.sql(sql).to_pydict(), ref.sql(sql).to_pydict()
    _same_rows(got, want, ordered=True)
    (fill,) = _execs(port, sql, LeftCountZeroFillExec)
    assert _execs(ref, sql, RefLeftCountZeroFillExec)
    assert type(fill.input) is TorchGroupAggregateExec
    aggs = _execs(port, sql, TorchGroupAggregateExec)
    assert len(aggs) == 2 and all(a.fallbacks == 0 for a in aggs)
    assert sum(got["custdist"]) == 1500     # every customer counted once


def test_q20_inner_chain_reads_its_aggregate_build(tpch):
    """Q20's inner chain: its first build is the (l_partkey, l_suppkey)
    aggregate, keyed on both columns, and its residual reads the sum."""
    port, _ref = tpch
    execs = _execs(port, TPCH[20], TorchJoinChainRowsExec)
    inner = [e for e in execs if any(
        type(n) is TorchGroupAggregateExec for n in _walk(e))]
    (ex,) = [e for e in inner if not any(
        type(n) is TorchJoinChainRowsExec for n in _walk(e) if n is not e)]
    assert [b.join_type for b in ex.builds] == ["INNER", "LEFTSEMI"]
    assert len(ex.builds[0].probe_keys) == 2
    assert ex.predicate is not None


# --- the row-returning chain on a seeded star ---------------------------------

def _star_batches(seed=7):
    """fact (two batches; every row of the first has tag 9), d1 and d2,
    with NULL keys on both sides of the first hop."""
    rng = np.random.default_rng(seed)
    n_d1, n_d2 = 300, 40

    def fact(n, tag):
        k1 = rng.integers(0, n_d1 + 20, n)
        return {"k1": (k1, rng.random(n) > 0.1),
                "v": (rng.normal(size=n).round(3), None),
                "q": (rng.integers(0, 1000, n), None),
                "tag": (np.full(n, 9) if tag is None
                        else rng.integers(0, 5, n), None)}
    d1_id = np.arange(n_d1)
    d1_valid = np.ones(n_d1, bool)
    d1_valid[[3, 17, 42]] = False
    return [fact(600, None), fact(4000, 0)], {
        "id": (d1_id, d1_valid), "k2": (rng.integers(0, n_d2, n_d1), None),
        "w": (rng.integers(1, 100, n_d1), None)}, {
        "id": (np.arange(n_d2), None),
        "name": (np.array([f"g{i % 7}" for i in range(n_d2)], object),
                 None)}


def _ref_batch(cols):
    fields, out = [], []
    for name, (data, valid) in cols.items():
        if data.dtype == object:
            c = df.Column.from_numpy(data)
        else:
            c = df.Column.from_numpy(np.asarray(data, np.int64)
                                     if data.dtype.kind == "i" else data,
                                     validity=valid)
        fields.append(df.Field(name, c.dtype, valid is not None))
        out.append(c)
    return df.Batch(df.Schema(fields), out, len(out[0]))


def _star_pair():
    port, ref = _sessions()
    facts, d1, d2 = _star_batches()
    fb = [_ref_batch(f) for f in facts]
    ref.register_table("fact", df.MemTable(fb[0].schema, [fb]))
    pb = [twin(b) for b in fb]
    port.register_table("fact", dft.MemTable(pb[0].schema, [pb]))
    register_both(port, ref, "d1", _ref_batch(d1))
    register_both(port, ref, "d2", _ref_batch(d2))
    return port, ref


STAR_ROWS = {
    "inner_dict_payload": (
        "SELECT f.v, f.q, d1.w, d2.name FROM fact f JOIN d1 ON f.k1 = d1.id "
        "JOIN d2 ON d1.k2 = d2.id WHERE f.tag < 4"),
    "semi": ("SELECT f.q, d1.w FROM fact f JOIN d1 ON f.k1 = d1.id "
             "WHERE f.k1 IN (SELECT id FROM d1 WHERE w > 50)"),
    "anti": ("SELECT f.q, f.v FROM fact f JOIN d1 ON f.k1 = d1.id "
             "WHERE NOT EXISTS (SELECT 1 FROM d2 WHERE d2.id = d1.k2 "
             "AND d2.name = 'g3')"),
    "residual": ("SELECT f.q, d1.w, d2.name FROM fact f "
                 "JOIN d1 ON f.k1 = d1.id JOIN d2 ON d1.k2 = d2.id "
                 "WHERE f.q > d1.w * 5 AND d2.name <> 'g1'"),
    "ordered": ("SELECT f.q, d2.name FROM fact f JOIN d1 ON f.k1 = d1.id "
                "JOIN d2 ON d1.k2 = d2.id ORDER BY f.q DESC, d2.name "
                "LIMIT 25"),
    "keeps_nothing": ("SELECT f.q, d2.name FROM fact f "
                      "JOIN d1 ON f.k1 = d1.id JOIN d2 ON d1.k2 = d2.id "
                      "WHERE d1.w > 1000"),
    # a SEMI and an ANTI hop filtered by `member <> / < probe` (TPC-H Q21's
    # shape): min/max tables keyed on d1.k2
    "filtered_semi": ("SELECT f.q, d1.w FROM fact f JOIN d1 ON f.k1 = d1.id "
                      "WHERE EXISTS (SELECT 1 FROM d1 m WHERE m.k2 = d1.k2 "
                      "AND m.w <> d1.w)"),
    "filtered_anti": ("SELECT f.q, d1.k2 FROM fact f JOIN d1 ON f.k1 = d1.id "
                      "WHERE NOT EXISTS (SELECT 1 FROM d1 m WHERE "
                      "m.k2 = d1.k2 AND m.w < d1.w - 20)"),
}


@pytest.mark.parametrize("case", sorted(STAR_ROWS))
def test_star_rows_match_jax_package(case):
    """INNER, SEMI and ANTI hops, NULL probe and build keys, a residual,
    a dictionary payload output and a spine batch that keeps no row: the
    port's chain (`chain_rows`' plain version) returns the rows of the
    JAX package's DeviceJoinChainRowsExec."""
    sql = STAR_ROWS[case]
    port, ref = _star_pair()
    assert _execs(ref, sql, DeviceJoinChainRowsExec)
    got, want = port.sql(sql).to_pydict(), ref.sql(sql).to_pydict()
    _same_rows(got, want, ordered="ORDER BY" in sql)
    (ex,) = _execs(port, sql, TorchJoinChainRowsExec)
    assert ex.fallbacks == 0
    n = len(next(iter(got.values())))
    assert (n == 0) == (case == "keeps_nothing")
    if case in ("semi", "anti"):
        assert ("LEFTSEMI" if case == "semi" else "LEFTANTI") in \
            ex.display_line()
    if case.startswith("filtered"):
        assert "filter=" in ex.display_line()
    if case == "residual":
        assert ex.predicate is not None


def test_chain_rows_outputs_in_spine_order_with_dictionaries():
    """One spine batch through `chain_rows` (CPU: its plain version): the
    kept rows in spine order, a payload string decoded through its build
    dictionary, and the first spine batch (all tag 9) keeping nothing."""
    port, _ref = _star_pair()
    sql = STAR_ROWS["inner_dict_payload"]
    (ex,) = _execs(port, sql, TorchJoinChainRowsExec)
    spec, inputs, _staged = ex.prepare_rows(port.task_context())
    assert len(inputs) == 2
    first, second = inputs
    (cols, aux, rows, _view) = first
    assert all(d.numel() == 0 for d, _v in chain_rows(spec, cols, aux, rows))
    cols, aux, rows, view = second
    got = chain_rows(spec, cols, aux, rows)
    want = chain_rows_plain(spec, cols, aux, rows)
    for (gd, gv), (wd, wv) in zip(got, want):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)
    # the kept rows by numpy, in spine order
    facts, d1, d2 = _star_batches()
    k1, k1v = facts[1]["k1"]
    d1_id_valid = d1["id"][1]
    ok = k1v & (facts[1]["tag"][0] < 4) & (k1 < 300)
    ok &= d1_id_valid[np.clip(k1, 0, 299)]
    np.testing.assert_array_equal(got[1][0].numpy(), facts[1]["q"][0][ok])
    names_idx = d1["k2"][0][k1[ok]]
    dic = view.columns[ex.out_exprs[3].index].dictionary
    assert list(dic.values[got[3][0].numpy()]) == \
        list(d2["name"][0][names_idx])


def _spread_data(seed=11):
    """fact in three batches of 5,000, 7,000 and 9,000 rows (the probe key
    a 10% NULL in the last), a dimension d1 of 400 rows keyed 0..399 and
    d2 of 40: survivors spread over the spine batches and over many of the
    row walk's tiles."""
    rng = np.random.default_rng(seed)
    facts = [{"k1": (rng.integers(0, 400, n),
                     rng.random(n) > 0.1 if nulls else None),
              "q": (rng.integers(0, 1000, n), None),
              "v": (rng.normal(size=n).round(3), None)}
             for n, nulls in ((5000, False), (7000, False), (9000, True))]
    d1 = {"id": (np.arange(400), None),
          "k2": (rng.integers(0, 40, 400), None),
          "w": (rng.integers(1, 100, 400), None)}
    d2 = {"id": (np.arange(40), None),
          "name": (np.array([f"g{i % 7}" for i in range(40)], object), None)}
    return facts, d1, d2


def _spread_pair():
    port, ref = _sessions()
    facts, d1, d2 = _spread_data()
    fb = [_ref_batch(f) for f in facts]
    ref.register_table("fact", df.MemTable(fb[0].schema, [fb]))
    pb = [twin(b) for b in fb]
    port.register_table("fact", dft.MemTable(pb[0].schema, [pb]))
    register_both(port, ref, "d1", _ref_batch(d1))
    register_both(port, ref, "d2", _ref_batch(d2))
    return port, ref


SPREAD_ROWS = {
    # about a third of every batch, in runs and gaps across its tiles
    "spread": ("SELECT f.q, f.v, d1.w, d2.name FROM fact f "
               "JOIN d1 ON f.k1 = d1.id JOIN d2 ON d1.k2 = d2.id "
               "WHERE f.q % 3 = 0 AND d1.w > 20", None),
    # every spine row (but the NULL keys of the last batch)
    "all": ("SELECT f.q, d1.w FROM fact f JOIN d1 ON f.k1 = d1.id",
            5000 + 7000),
    "none": ("SELECT f.q, d2.name FROM fact f JOIN d1 ON f.k1 = d1.id "
             "JOIN d2 ON d1.k2 = d2.id WHERE f.q > 5000", 0),
}


@pytest.mark.parametrize("case", sorted(SPREAD_ROWS))
def test_rows_over_tiles_and_batches_match_jax_package(case):
    """A row-returning chain over three spine batches whose survivors
    spread over many tiles of the row walk, none survive, or every row
    with a valid key survives: the JAX package's rows in the same order
    (spine order, batch after batch), and each batch's rows in spine order
    by numpy."""
    sql, count = SPREAD_ROWS[case]
    port, ref = _spread_pair()
    assert _execs(ref, sql, DeviceJoinChainRowsExec)
    got, want = port.sql(sql).to_pydict(), ref.sql(sql).to_pydict()
    _same_rows(got, want, ordered=True)
    (ex,) = _execs(port, sql, TorchJoinChainRowsExec)
    assert ex.fallbacks == 0
    n = len(got["q"])
    if count is not None:
        assert n >= count and (count == 0) == (n == 0)
    else:
        spec, inputs, _staged = ex.prepare_rows(port.task_context())
        assert len(inputs) == 3
        kept = [chain_rows(spec, c, a, r)[0][0].numpy()
                for c, a, r, _v in inputs]
        assert all(len(k) > 100 for k in kept)
        assert np.concatenate(kept).tolist() == got["q"]
        facts, d1, _d2 = _spread_data()
        for k, f in zip(kept, facts):
            (k1, k1v), (q, _n) = f["k1"], f["q"]
            keep = (q % 3 == 0) & (d1["w"][0][k1] > 20)
            if k1v is not None:
                keep &= k1v
            np.testing.assert_array_equal(k, q[keep])


def test_with_children_keeps_the_chain():
    port, _ref = _star_pair()
    (ex,) = _execs(port, STAR_ROWS["semi"], TorchJoinChainRowsExec)
    again = ex.with_children(ex.children())
    assert type(again) is TorchJoinChainRowsExec
    assert again.display_line() == ex.display_line()
    assert [b.join_type for b in again.builds] == \
        [b.join_type for b in ex.builds]
    assert [str(e) for e in again.out_exprs] == \
        [str(e) for e in ex.out_exprs]


def test_small_spine_stays_on_the_host():
    """At the default threshold (200,000 spine rows) the star stays a host
    join, as in the JAX package."""
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    facts, d1, d2 = _star_batches()
    for name, cols in (("fact", facts[1]), ("d1", d1), ("d2", d2)):
        register_both(port, ref, name, _ref_batch(cols))
    sql = STAR_ROWS["inner_dict_payload"]
    assert not _execs(port, sql, TorchJoinChainRowsExec)
    assert not _execs(ref, sql, DeviceJoinChainRowsExec)
    _same_rows(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict(), False)


@pytest.mark.parametrize("case", ["inner_dict_payload", "semi"])
def test_device_join_rows_off_plans_no_rows_chain(case):
    """`SET datafusion.tpu.device_join_rows = false` plans no row chain in
    either package (`UseDeviceJoinRows.enabled`) and leaves the rows as the
    JAX package gives them under the same setting."""
    port, ref = _star_pair()
    sql = STAR_ROWS[case]
    for c in (port, ref):
        c.sql("SET datafusion.tpu.device_join_rows = false")
    assert not _execs(port, sql, TorchJoinChainRowsExec)
    assert not _execs(ref, sql, DeviceJoinChainRowsExec)
    _same_rows(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict(), False)
    on, _ref = _star_pair()
    assert _execs(on, sql, TorchJoinChainRowsExec)


# --- the resident emit ---------------------------------------------------------

def _wide_agg_batch(n=420_000, seed=3):
    """More than 2^18 groups of (k, s): an int64 key with NULLs, a
    dictionary key, a decimal and a nullable integer."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-50_000, 150_000, n)
    kv = rng.random(n) > 0.01
    s = rng.integers(0, 5, n)
    dic = df.Column.from_numpy(np.array(["ab", "ac", "b", "ca", "d"],
                                        object)).dictionary
    d = rng.integers(-10**6, 10**6, n)
    v = rng.integers(0, 100, n)
    vv = rng.random(n) > 0.2
    dec = ref_dt.decimal(15, 2)
    cols = [df.Column(ref_dt.INT64, k, kv),
            df.Column(ref_dt.STRING, s.astype(np.int32), None, dic),
            df.Column(dec, d), df.Column(ref_dt.INT64, v, vv)]
    fields = [df.Field("k", ref_dt.INT64, True),
              df.Field("s", ref_dt.STRING, False), df.Field("d", dec, False),
              df.Field("v", ref_dt.INT64, True)]
    return df.Batch(df.Schema(fields), cols, n)


WIDE_AGG = ("SELECT k, s, count(*) c, count(v) cv, sum(d) sd, sum(v) sv "
            "FROM t GROUP BY k, s")


def test_resident_emit_matches_jax_package(monkeypatch):
    """A group table above 2^18 groups stays on the card in both
    packages (`_emit_device_resident` in the JAX package,
    `group_emit_columns` in the port): equal rows, with a NULL group key,
    a dictionary key, counts and a decimal sum."""
    calls = []
    orig = DeviceGroupAggregateExec._emit_device_resident

    def spy(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)
    monkeypatch.setattr(DeviceGroupAggregateExec, "_emit_device_resident",
                        spy)
    port, ref = _sessions()
    register_both(port, ref, "t", _wide_agg_batch())
    got, want = port.sql(WIDE_AGG).to_pydict(), ref.sql(WIDE_AGG).to_pydict()
    assert calls
    assert len(got["k"]) >= RESIDENT_EMIT_MIN_GROUPS
    assert None in got["k"]
    _same_rows(got, want, ordered=False)
    (ex,) = _execs(port, WIDE_AGG, TorchGroupAggregateExec)
    assert ex.resident_emits == 1 and ex.fallbacks == 0
    (batch,) = port.sql(WIDE_AGG).collect()
    assert all(c.device_born for c in batch.columns)


RESIDENT_FILTER = ("SELECT count(*), sum(s) FROM (SELECT g, h, count(*) "
                   "AS c, sum(v) AS s FROM t GROUP BY g, h) WHERE c > 1")


@pytest.mark.parametrize("sql", [
    RESIDENT_FILTER,
    "SELECT g, h FROM (SELECT g, h, count(*) AS c FROM t GROUP BY g, h) "
    "UNION SELECT g, h FROM (SELECT g, h, count(*) AS c FROM t "
    "GROUP BY g, h)"], ids=["filter", "union"])
def test_resident_emit_under_a_filter_and_a_union(sql):
    """An aggregate of more than 2^18 groups under a filter and under a
    UNION (1,200,000 rows; g in [0, 600,000), h in [0, 3), v in [-5, 5),
    int64 from `default_rng(1)`): the port's resident emit gives its host
    path's rows. The JAX package's `_emit_device_resident` returns `ng`
    rows whose columns hold `out_cap` padded entries, and raises here."""
    rng = np.random.default_rng(1)
    n = 1_200_000
    cols = {"g": rng.integers(0, 600_000, n), "h": rng.integers(0, 3, n),
            "v": rng.integers(-5, 5, n)}
    port, ref = _sessions()
    host = dft.SessionContext(CPU)
    host.sql("SET datafusion.tpu.device_aggregate = false")
    for c in (port, ref, host):
        c.register_arrays("t", cols)
    got = port.sql(sql).to_pydict()
    _same_rows(got, host.sql(sql).to_pydict(), ordered=False)
    (agg, *_rest) = _execs(port, sql, TorchGroupAggregateExec)
    assert agg.fallbacks == 0
    if sql == RESIDENT_FILTER:
        assert got == {"count(*)": [259_736], "sum(s)": [-294_413]}
    with pytest.raises(ValueError, match="could not be broadcast"):
        ref.sql(sql).to_pydict()


def test_group_emit_fields_unpack_the_packed_key():
    """`group_emit_columns` on the CPU (its plain version) against numpy
    over a hand-packed table: two keys, a dictionary code, a count and a
    sum valid only where its count is above 0."""
    rng = np.random.default_rng(4)
    ng = 4097
    a = rng.integers(0, 1000, ng)        # raw of key a: 0 is NULL
    b = rng.integers(0, 7, ng)           # raw of the dictionary key
    packed = a | (b << 10)
    cnt = rng.integers(0, 3, ng)
    s = rng.integers(-10**9, 10**9, ng)
    groups = torch.from_numpy(np.stack([packed, cnt, s, cnt]))
    fields = [EmitField(EMIT_KEY, torch.int32, 0, 0, 10, -5),
              EmitField(EMIT_DICT, torch.int32, 0, 10, 3),
              EmitField(EMIT_COUNT, torch.int64, 1),
              EmitField(EMIT_SUM, torch.int64, 2, count_row=3)]
    out = group_emit_columns(groups, fields)
    assert [d.dtype for d, _v in out] == [torch.int32, torch.int32,
                                          torch.int64, torch.int64]
    np.testing.assert_array_equal(out[0][0].numpy(), a - 1 - 5)
    np.testing.assert_array_equal(out[0][1].numpy(), a != 0)
    np.testing.assert_array_equal(out[1][0].numpy(), np.maximum(b - 1, 0))
    np.testing.assert_array_equal(out[1][1].numpy(), b != 0)
    np.testing.assert_array_equal(out[2][0].numpy(), cnt)
    assert out[2][1] is None
    np.testing.assert_array_equal(out[3][0].numpy(), s)
    np.testing.assert_array_equal(out[3][1].numpy(), cnt > 0)
    again = group_emit_columns_plain(groups, fields)
    assert all(torch.equal(x[0], y[0]) for x, y in zip(out, again))


def _q20_like_batches(seed=5):
    """A Q20-shaped inner query at a size whose aggregate has more than
    2^18 groups: li (partkey, suppkey, qty), ps (partkey, suppkey,
    avail), p (partkey, name)."""
    rng = np.random.default_rng(seed)
    n_part, n_supp = 120_000, 40
    pk = rng.integers(1, n_part + 1, 450_000)
    which = rng.integers(0, 4, len(pk))
    sk = (pk - 1 + which * (n_supp // 4 + 1)) % n_supp + 1
    ps_pk = np.repeat(np.arange(1, n_part + 1), 4)
    ps_sk = (ps_pk - 1 + np.tile(np.arange(4), n_part) *
             (n_supp // 4 + 1)) % n_supp + 1
    names = np.array(["forest a", "green b", "forest c", "navy d"], object)
    return ({"l_partkey": (pk, None), "l_suppkey": (sk, None),
             "l_quantity": (rng.integers(1, 51, len(pk)), None)},
            {"ps_partkey": (ps_pk, None), "ps_suppkey": (ps_sk, None),
             "ps_availqty": (rng.integers(1, 60, len(ps_pk)), None)},
            {"p_partkey": (np.arange(1, n_part + 1), None),
             "p_name": (names[rng.integers(0, 4, n_part)], None)})


Q20_LIKE = (
    "SELECT ps_partkey, ps_suppkey FROM ps WHERE ps_partkey IN "
    "(SELECT p_partkey FROM p WHERE p_name LIKE 'forest%') AND "
    "ps_availqty > (SELECT 0.5 * sum(l_quantity) FROM li WHERE "
    "l_partkey = ps_partkey AND l_suppkey = ps_suppkey)")


def test_resident_aggregate_feeds_a_rows_build(monkeypatch):
    """Q20's shape above 2^18 groups: the aggregate's output stays on the
    card and the chain's build stages from it with no host copy; the rows
    equal the JAX package's."""
    port, ref = _sessions()
    for name, cols in zip(("li", "ps", "p"), _q20_like_batches()):
        register_both(port, ref, name, _ref_batch(cols))
    emitted = []
    orig = TorchGroupAggregateExec._emit_resident

    def spy(self, *a, **k):
        out = orig(self, *a, **k)
        emitted.extend(out.columns)
        return out
    monkeypatch.setattr(TorchGroupAggregateExec, "_emit_resident", spy)
    got = port.sql(Q20_LIKE).to_pydict()
    want = ref.sql(Q20_LIKE).to_pydict()
    _same_rows(got, want, ordered=False)
    assert len(got["ps_partkey"]) > 0
    (agg,) = _execs(port, Q20_LIKE, TorchGroupAggregateExec)
    assert agg.resident_emits == 1
    assert emitted and all(c.device_born for c in emitted)
    # the build read the device tensors themselves: no host copy was made
    assert all(getattr(c, "_host_cache", None) is None for c in emitted)
    (ex,) = _execs(port, Q20_LIKE, TorchJoinChainRowsExec)
    assert ex.fallbacks == 0


# --- the device-born column ----------------------------------------------------

def test_device_born_column_copies_once():
    data = torch.arange(10, dtype=torch.int64)
    valid = torch.arange(10) % 3 != 0
    c = Column(dt.INT64, data, valid)
    assert c.device_born and len(c) == 10 and c.has_nulls
    h = c.data_host()
    assert isinstance(h, np.ndarray) and c.data_host() is h
    v = c.validity_host()
    assert c.validity_host() is v
    np.testing.assert_array_equal(h, np.arange(10))
    np.testing.assert_array_equal(v, np.arange(10) % 3 != 0)
    cache = DeviceColumnCache()
    d2, v2 = to_device(c, CPU, cache)
    assert d2 is data and v2 is valid and len(cache) == 0
    assert c.to_pylist()[:4] == [None, 1, 2, None]
    assert not c.is_unique_nonnull()        # it has a validity
    u = Column(dt.INT64, torch.tensor([5, 3, 9]))
    assert u.is_unique_nonnull() and not u.is_sorted_nondecreasing()
    assert u.dense_key_stats() == (3, 7)


def test_device_born_dictionary_unifies_with_host_validity():
    # a dict-coded device-born column with NULLs (as a resident key emit or
    # a rows exec's string output gives) remapped onto a merged dictionary
    # becomes a host column whose data and validity are both numpy
    from datafusion_tpu_torch.common.column import Dictionary
    from datafusion_tpu_torch.physical.kernels import unify_dictionaries
    left = Column(dt.STRING, torch.tensor([0, 2, 1, 0], dtype=torch.int32),
                  torch.tensor([True, True, False, False]),
                  Dictionary(np.array(["b", "d", "f"], dtype=object)))
    right = Column(dt.STRING, np.array([1, 0], dtype=np.int32), None,
                   Dictionary(np.array(["a", "d"], dtype=object)))
    a, b = unify_dictionaries(left, right)
    assert not a.device_born and a.dictionary is b.dictionary
    assert isinstance(a.validity_host(), np.ndarray)
    assert a.to_pylist() == ["b", "f", None, None]
    assert b.to_pylist() == ["d", "a"]
    assert b.validity_host() is None
