"""Staging-time hop composition and folding through the port on the CPU,
against the JAX package.

The JAX package composes a snowflake hop into an earlier INNER hop's
payload matrix (`_compose_staged_hops`, `device_join_chain.py:786`) and
folds a direct-address hop's table and payload into one matrix
(`_fold_lut_pmat`, `:719`). A spy on those two methods reads what the
reference chose and computed; nothing in the JAX package changes. The
port runs the plain versions of `chain_compose` and `chain_fold`
(`SessionContext(cpu)`). Compared exactly: which hops compose (hop ->
owner, tag) and fold (the reference's span and lanes), the composed
values of every owner row the owner's build keeps, and the rows of every
query and edge case.
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.physical.plan import device_join_chain as R
from datafusion_tpu.tpch.queries import QUERIES as TPCH
from datafusion_tpu_torch.device.join_chain import (
    AggregateSpec, chain_aggregate_plain, chain_rows_plain)
from datafusion_tpu_torch.physical.plan.device_join_chain import (
    TorchChainExec, TorchJoinChainAggregateExec, TorchJoinChainRowsExec)
from torch_twin import register_tpch_both

CPU = torch.device("cpu")

# what the reference composes and folds for each TPC-H query at SF 0.01,
# seed 1: per chain exec, ({hop: (owner, tag)}, {hop: (span, width)})
EXPECTED = {
    2: [({1: (0, "inner"), 2: (0, "member")}, {0: (128, 7)})],
    3: [({1: (0, "member")}, {0: (65536, 6)})],
    4: [({}, {})],
    5: [({1: (0, "inner"), 2: (0, "member"), 4: (3, "inner")},
         {0: (128, 8), 3: (65536, 6)})],
    7: [({1: (0, "inner"), 3: (2, "inner"), 4: (2, "inner")},
         {0: (128, 5), 2: (65536, 8)})],
    8: [({1: (0, "inner"), 4: (3, "inner"), 5: (3, "inner"),
          6: (3, "member")}, {0: (128, 5), 3: (65536, 11)})],
    9: [({1: (0, "inner")}, {0: (128, 5), 3: (65536, 2)})],
    10: [({1: (0, "inner"), 2: (0, "inner")}, {0: (65536, 16)})],
    11: [({1: (0, "member")}, {0: (128, 4)})] * 2,
    12: [({}, {0: (65536, 2)})],
    14: [({}, {0: (2048, 2)})],
    16: [({}, {0: (2048, 4)})],
    17: [({1: (0, "inner")}, {0: (2048, 6)})],
    18: [({1: (0, "inner"), 2: (0, "member")}, {0: (65536, 13)})],
    19: [({}, {0: (2048, 4)})],
    21: [({1: (0, "member")}, {0: (128, 5)})],
}


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _port_execs(ctx, sql):
    return [n for n in _walk(ctx.sql(sql).create_physical_plan())
            if isinstance(n, TorchChainExec)]


def _marker(sb):
    """The reference's ("cmp", owner, tag, lanes) marker of a composed
    hop's staged entry, or None."""
    m = sb[8]
    return m if isinstance(m, tuple) and m[0] == "cmp" else None


@pytest.fixture
def spy(monkeypatch):
    """Every reference staging's (composed staged builds, folded staged
    builds), in the order the reference staged them."""
    seen = []
    compose, fold = (R.DeviceJoinChainAggregateExec._compose_staged_hops,
                     R.DeviceJoinChainAggregateExec._fold_lut_pmat)

    def compose_spy(self, staged, *a):
        out = compose(self, staged, *a)
        seen.append([out, None])
        return out

    def fold_spy(self, staged, *a):
        out = fold(self, staged, *a)
        seen[-1][1] = out
        return out
    monkeypatch.setattr(R.DeviceJoinChainAggregateExec,
                        "_compose_staged_hops", compose_spy)
    monkeypatch.setattr(R.DeviceJoinChainAggregateExec, "_fold_lut_pmat",
                        fold_spy)
    return seen


def _reference_choice(composed, folded):
    comps = {bi: (m[1], m[2]) for bi, sb in enumerate(composed)
             if (m := _marker(sb)) is not None}
    folds = {bi: tuple(int(x) for x in sb[0].shape)
             for bi, sb in enumerate(folded) if sb[8] == "lutmat"}
    return comps, folds


@pytest.fixture(scope="module")
def tpch():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_tpch_both(port, ref, sf=0.01, seed=1)
    return port, ref


def _key(choice):
    return repr(choice)


@pytest.mark.parametrize("q", range(1, 23))
def test_same_hops_compose_and_fold(tpch, spy, q):
    """For each TPC-H query the port's staging composes and folds the hops
    the reference does, with the reference's tags, spans and lanes (the
    table in `EXPECTED`), over every chain that runs on the device in both
    (Q22's falls back in both before it stages)."""
    port, ref = tpch
    ref.sql(TPCH[q]).to_pydict()
    want = [_reference_choice(c, f) for c, f in spy]
    port.sql(TPCH[q]).to_pydict()
    execs = [ex for ex in _port_execs(port, TPCH[q]) if not ex.fallbacks]
    got = [ex.compose_plan(ex.stage_builds(port.task_context(),
                                           compose=False))
           for ex in execs]
    assert sorted(got, key=_key) == sorted(want, key=_key)
    assert sorted(got, key=_key) == sorted(EXPECTED.get(q, []), key=_key)
    for ex in execs:
        staged = ex.stage_builds(port.task_context())
        assert {bi: (s.compose.owner, s.compose.tag)
                for bi, s in enumerate(staged) if s.compose} == \
            ex.compose_plan(staged)[0]


@pytest.mark.parametrize("q", sorted(EXPECTED))
def test_compose_plan_reads_no_host_column(tpch, monkeypatch, q):
    """`compose_plan` takes what it reads of the build columns from the
    staged tables and the card, never from a host copy: with
    `Column.data_host` raising, it still picks the reference's hops (the
    table in `EXPECTED`) for every TPC-H chain."""
    from datafusion_tpu_torch.common.column import Column
    port, _ref = tpch
    port.sql(TPCH[q]).to_pydict()
    execs = [ex for ex in _port_execs(port, TPCH[q]) if not ex.fallbacks]
    staged = [ex.stage_builds(port.task_context(), compose=False)
              for ex in execs]

    def no_host(self):
        raise AssertionError("compose_plan read a build column on the host")
    monkeypatch.setattr(Column, "data_host", no_host)
    got = [ex.compose_plan(st) for ex, st in zip(execs, staged)]
    assert sorted(got, key=_key) == sorted(EXPECTED[q], key=_key)


def _lane_values(pm, lane, kind):
    """A payload column's values from the reference's int32 lanes, decoded
    as `_chain_walk` decodes them (`:1618-1632`)."""
    if kind == "i64":
        return (pm[:, lane].astype(np.int64) << 32) | \
            pm[:, lane + 1].astype(np.uint32).astype(np.int64)
    if kind == "f32":
        return pm[:, lane].view(np.float32)
    if kind == "bool":
        return pm[:, lane] != 0
    return pm[:, lane].astype(np.int64)


@pytest.mark.parametrize("q", [2, 5, 21])
def test_composed_values_equal_the_reference_lanes(tpch, spy, q):
    """Each composed hop's words equal the lanes the reference's program
    appends, at every owner row the owner's build keeps: found where the
    reference's found lane is set, and for an INNER hop its payload at the
    port's row equal to the reference's payload lanes."""
    port, ref = tpch
    ref.sql(TPCH[q]).to_pydict()
    ((composed, _folded),) = spy
    (ex,) = _port_execs(port, TPCH[q])
    staged = ex.stage_builds(port.task_context())
    checked = 0
    for bi, sb in enumerate(composed):
        m = _marker(sb)
        if m is None:
            continue
        _c, owner, tag, info = m
        c = staged[bi].compose
        assert (c.owner, c.tag) == (owner, tag)
        pm = np.asarray(composed[owner][2])
        rows = staged[owner].table.rows.numpy()
        keep = np.sort(rows[rows >= 0])
        port_row = c.words[:, c.word].numpy()[keep]
        found = pm[keep, info[0]] != 0
        np.testing.assert_array_equal(port_row >= 0, found)
        if tag == "inner":
            _fl, base, pspec = info
            starts, _tot = R.DeviceJoinChainAggregateExec._pspec_lanes(pspec)
            s = staged[bi]
            at = port_row[found]
            for t, (kind, _dt, has) in enumerate(pspec):
                col = s.batch.columns[s.col_map[ex.builds[bi].payload[t]]]
                lane = base + starts[t]
                want = _lane_values(pm[keep][found], lane, kind)
                np.testing.assert_array_equal(col.data_host()[at], want)
                if has:
                    width = 2 if kind == "i64" else 1
                    np.testing.assert_array_equal(
                        col.validity_host()[at],
                        pm[keep][found][:, lane + width] != 0)
        checked += 1
    assert checked == len(EXPECTED[q][0][0])


def _tables(ex, spec, inputs):
    """The group table (compacted, by key) or the rows of one walk over
    `inputs`, by the plain versions."""
    if isinstance(ex, TorchJoinChainRowsExec):
        out = []
        for cols, aux, n, _view in inputs:
            out += [(d.clone(), v.clone())
                    for d, v in chain_rows_plain(spec, cols, aux, n)]
        return out
    table = spec.new_table(CPU)
    rows = sum(n for _c, _a, n in inputs)
    dset = spec.distinct_set(rows, CPU)
    overflow = torch.zeros(1, dtype=torch.int32)
    for cols, aux, n in inputs:
        chain_aggregate_plain(spec, cols, aux, n, table, overflow, dset=dset)
    if isinstance(spec, AggregateSpec):
        return [table]
    live = table[:, table[0] != -1]
    return [live[:, torch.argsort(live[0])]]


def _walks(ex, tctx, compose):
    if isinstance(ex, TorchJoinChainRowsExec):
        spec, inputs, _staged = ex.prepare_rows(tctx, compose)
    else:
        spec, _p, _n, _s, inputs, _staged = ex.prepare(tctx, compose)
    return spec, _tables(ex, spec, inputs)


@pytest.mark.parametrize("q", [2, 5, 7, 8, 9, 21])
def test_same_results_with_and_without_composition(tpch, q):
    """The walks over the chain staged with its compositions and folds and
    without them (`stage_builds(compose=False)`) give identical group
    tables and rows, and the composed chain really takes the new routes."""
    port, _ref = tpch
    routes = 0
    for ex in _port_execs(port, TPCH[q]):
        spec, got = _walks(ex, port.task_context(), True)
        plain, want = _walks(ex, port.task_context(), False)
        assert not any(h.compose or h.fold for h in plain.chain.hops)
        routes += sum(h.compose is not None or h.fold is not None
                      for h in spec.chain.hops)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert all(torch.equal(x, y) for x, y in zip(a, b)) \
                if isinstance(a, tuple) else torch.equal(a, b)
    assert routes >= 2


# --- edge cases ---------------------------------------------------------------

def pair(data):
    """The port's and the reference's sessions over `data`: a spine `f`,
    an owner `d` (keys with NULLs made from NaN), a dimension `e` keyed by
    `d`'s payload, a hashed one `h`, a member table `m` and, for the fold
    budget, the spine `fb` and the builds `b16` and `b17`."""
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for c in (port, ref):
        for name, cols in data.items():
            c.register_arrays(name, cols)
        c.sql("CREATE TABLE d AS SELECT id, CASE WHEN isnan(ek) THEN NULL "
              "ELSE CAST(ek AS BIGINT) END ek, wide, flag, ek32, hk, x, b "
              "FROM d0")
    return port, ref


def _edge_data(seed=5):
    rng = np.random.default_rng(seed)
    nf, nd, ne = 3000, 200, 40
    ek = rng.integers(0, ne, nd).astype(float)
    ek[rng.random(nd) < 0.15] = np.nan
    hid = rng.choice(1 << 40, ne, replace=False)
    nb = 1 << 16
    data = {
        "f": {"k": rng.integers(0, nd, nf), "v": rng.integers(0, 100, nf),
              "s": rng.integers(0, 12, nf)},
        # the spine of the fold budget's cases: larger than its build
        "fb": {"g": rng.integers(0, 7, 2 * nb),
               "bk": rng.integers(0, nb, 2 * nb) * 16},
        "d0": {"id": np.arange(nd), "ek": ek,
               "wide": rng.integers(-20, ne + 20, nd),
               "flag": rng.integers(0, 5, nd),
               "ek32": rng.integers(0, ne, nd).astype(np.int32),
               "hk": rng.choice(hid, nd),
               "x": rng.normal(size=nd).astype(np.float32),
               "b": rng.random(nd) < 0.5},
        "e": {"id": np.arange(ne), "w": rng.integers(0, 6, ne)},
        "h": {"id": hid, "w": rng.integers(0, 6, ne)},
        "m": {"k": rng.integers(0, ne, 300), "s": rng.integers(0, 12, 300)},
    }
    # span 2^20 (keys 0, 16, ..., 16 (2^16 - 1)) x (1 + 15 lanes) = 2^24
    # folds; 16 lanes do not
    b = {"id": np.arange(nb) * 16}
    for j in range(8):
        b[f"c{j}"] = rng.integers(0, 1000, nb)
    b["c32"] = rng.integers(0, 1000, nb).astype(np.int32)
    data["b16"] = {k: v for k, v in b.items() if k != "c7"}
    data["b17"] = {k: v for k, v in b.items() if k != "c32"}
    return data


_SUMS = ("sum(b.c0) s0, sum(b.c1) s1, sum(b.c2) s2, sum(b.c3) s3, "
         "sum(b.c4) s4, sum(b.c5) s5, sum(b.c6) s6")
EDGE_SQL = {
    "null_owner_key": (
        "SELECT e.w, count(*) c, sum(f.v) s FROM f JOIN d ON f.k = d.id "
        "JOIN e ON d.ek = e.id GROUP BY e.w ORDER BY e.w"),
    "owner_key_out_of_range": (
        "SELECT e.w, count(*) c, sum(f.v) s FROM f JOIN d ON f.k = d.id "
        "JOIN e ON d.wide = e.id GROUP BY e.w ORDER BY e.w"),
    "owner_row_dropped": (
        "SELECT e.w, count(*) c, sum(f.v) s FROM f JOIN d ON f.k = d.id "
        "JOIN e ON d.ek = e.id WHERE d.flag > 1 GROUP BY e.w ORDER BY e.w"),
    "anti": (
        "SELECT d.flag, count(*) c FROM f JOIN d ON f.k = d.id WHERE NOT "
        "EXISTS (SELECT 1 FROM e WHERE e.id = d.ek AND e.w > 2) "
        "GROUP BY d.flag ORDER BY d.flag"),
    "min_max": (
        "SELECT d.flag, count(*) c FROM f JOIN d ON f.k = d.id WHERE EXISTS "
        "(SELECT 1 FROM m WHERE m.k = d.ek AND m.s < f.s) "
        "GROUP BY d.flag ORDER BY d.flag"),
    "int32_owner_column": (
        "SELECT e.w, count(*) c, sum(f.v) s FROM f JOIN d ON f.k = d.id "
        "JOIN e ON d.ek32 = e.id GROUP BY e.w ORDER BY e.w"),
    "hashed_composed_hop": (
        "SELECT h.w, count(*) c, sum(f.v) s FROM f JOIN d ON f.k = d.id "
        "JOIN h ON d.hk = h.id GROUP BY h.w ORDER BY h.w"),
    "folded_payload": (
        "SELECT d.ek, d.flag, count(*) c, max(d.x) mx, sum(CASE WHEN d.b "
        "THEN f.v ELSE 0 END) sb FROM f JOIN d ON f.k = d.id "
        "GROUP BY d.ek, d.flag ORDER BY d.ek, d.flag"),
    "fold_budget_2_24": (
        f"SELECT f.g, {_SUMS}, sum(b.c32) s32 FROM fb f JOIN b16 b "
        "ON f.bk = b.id GROUP BY f.g ORDER BY f.g"),
    "fold_budget_over_2_24": (
        f"SELECT f.g, {_SUMS}, sum(b.c7) s7 FROM fb f JOIN b17 b "
        "ON f.bk = b.id GROUP BY f.g ORDER BY f.g"),
}
# what each case composes and folds, in both packages
EDGE_EXPECTED = {
    "null_owner_key": ({1: (0, "inner")}, {0: (256, 7)}),
    "owner_key_out_of_range": ({1: (0, "inner")}, {0: (256, 6)}),
    "owner_row_dropped": ({1: (0, "inner")}, {0: (256, 7)}),
    "anti": ({1: (0, "member")}, {0: (256, 7)}),
    "min_max": ({1: (0, "mmx")}, {0: (256, 9)}),
    "int32_owner_column": ({1: (0, "inner")}, {0: (256, 5)}),
    "hashed_composed_hop": ({1: (0, "inner")}, {0: (256, 6)}),
    "folded_payload": ({}, {0: (256, 8)}),
    "fold_budget_2_24": ({}, {0: (1 << 20, 16)}),
    "fold_budget_over_2_24": ({}, {}),
}


def edge_cases():
    """{case: (data, sql)} of the composition edge cases."""
    data = _edge_data()
    return {name: (data, sql) for name, sql in EDGE_SQL.items()}


@pytest.fixture(scope="module")
def edge():
    return pair(_edge_data())


@pytest.mark.parametrize("case", sorted(EDGE_SQL))
def test_edge_case_matches_jax_package(edge, spy, case):
    """Each edge case gives the reference's rows exactly, composes and
    folds what the reference does, and runs with no fallback: a NULL owner
    key and one outside the composed hop's [lo, hi] find nothing, an owner
    row the owner's build predicate drops is composed but never read, an
    ANTI hop and a filtered SEMI (min/max) hop compose, an int32 owner
    column probes an int64 build key, a composed hop's table is hashed, a
    folded hop's nullable int64, float32 and bool payloads load from its
    records, and a fold at span x (1 + lanes) = 2^24 is taken and one lane
    more is not."""
    port, ref = edge
    sql = EDGE_SQL[case]
    want = ref.sql(sql).to_pydict()
    got = port.sql(sql).to_pydict()
    assert got == want and sum(want["c"] if "c" in want else want["s0"])
    assert [_reference_choice(c, f) for c, f in spy] == [EDGE_EXPECTED[case]]
    (ex,) = _port_execs(port, sql)
    assert ex.fallbacks == 0
    staged = ex.stage_builds(port.task_context())
    assert ex.compose_plan(staged) == EDGE_EXPECTED[case]
    if case == "owner_row_dropped":
        assert staged[0].spec.pred is not None
        assert staged[0].table.live < staged[0].batch.num_rows
    if case == "hashed_composed_hop":
        from datafusion_tpu_torch.device.join_chain import TAB_HASH
        assert staged[1].table.kind == TAB_HASH
    if case == "folded_payload":
        spec = ex.prepare(port.task_context())[0]
        fold = spec.chain.hops[0].fold
        assert len(fold.columns) == 4 and fold.valid is not None


@pytest.mark.parametrize("case", sorted(EDGE_SQL))
def test_edge_compose_plan_reads_no_host_column(edge, monkeypatch, case):
    """The edge cases' choice with `Column.data_host` raising: a filtered
    owner and a min/max hop take their extremes from the card, and the
    hops are still the reference's (`EDGE_EXPECTED`)."""
    from datafusion_tpu_torch.common.column import Column
    port, _ref = edge
    (ex,) = _port_execs(port, EDGE_SQL[case])
    staged = ex.stage_builds(port.task_context(), compose=False)

    def no_host(self):
        raise AssertionError("compose_plan read a build column on the host")
    monkeypatch.setattr(Column, "data_host", no_host)
    assert ex.compose_plan(staged) == EDGE_EXPECTED[case]


def test_reduced_chain_replays_on_the_host_with_composition(tpch):
    """Q10's and Q18's keys reduce by functional dependence while their
    hops compose and fold: the emit's host replay reads the build batches
    and tables (`_fd_finalize`), so the rows equal the reference's, and
    the reduced walk runs over composed hops."""
    port, ref = tpch
    for q in (10, 18):
        (ex,) = _port_execs(port, TPCH[q])
        assert isinstance(ex, TorchJoinChainAggregateExec)
        spec, plan, _n, _s, _i, _st = ex.prepare(port.task_context())
        assert plan.dropped
        assert any(h.compose is not None for h in spec.chain.hops)
        assert port.sql(TPCH[q]).to_pydict() == ref.sql(TPCH[q]).to_pydict()
