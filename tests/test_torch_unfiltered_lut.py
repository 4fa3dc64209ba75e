"""The join chain's unfiltered direct-address tables in the port, held
against the JAX package.

The JAX package keeps an INNER build side whose unfiltered keys are unique
non-null integers of a bounded packed span as one direct-address table,
keyed by its key columns alone (`_unfiltered_lut`, `device_join_chain.py:
177-225`), and masks it by each query's build predicate (`masklut`,
`:632-652`). The port stages such a side once without its predicate, caches
it in the session's `ChainCaches` under the same key, and masks it at each
use (`chain_mask`), so a new literal stages no table. Both packages get the
same seeded TPC-H tables at SF 0.01 (where orders is eligible too) and
`test_torch_memory.py`'s tables; the port runs on the CPU, where its
kernels run their plain versions.
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.physical.plan import device_join_chain as ref_djc
from datafusion_tpu_torch.physical.plan import device_join_chain as djc
from datafusion_tpu_torch.physical.plan.device_join_chain import (
    TorchJoinChainAggregateExec, TorchJoinChainRowsExec)
from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH
from test_torch_join_chain import _execs, _same_rows
from test_torch_memory import AGG, _Spy, _sessions, _tables
from torch_twin import register_tpch_both

CPU = torch.device("cpu")
ROWS_ON = "SET datafusion.tpu.device_join_rows_min_spine = 1"
NAMES = ("chain_build", "chain_mask", "chain_stage")

CHAINS = (TorchJoinChainAggregateExec, TorchJoinChainRowsExec)
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]


def _q2(region):
    return TPCH[2].replace("'EUROPE'", f"'{region}'")


# (query text of each literal in turn, the exec that runs its chain)
STREAMS = {
    "q3_segments": ([TPCH[3].replace("'BUILDING'", f"'{s}'")
                     for s in SEGMENTS], TorchJoinChainAggregateExec),
    "q5_regions": ([TPCH[5].replace("'ASIA'", f"'{r}'")
                    for r in ("ASIA", "EUROPE", "ASIA")],
                   TorchJoinChainAggregateExec),
    "q8_types": ([TPCH[8].replace("'ECONOMY ANODIZED STEEL'", f"'{t}'")
                  for t in ("ECONOMY ANODIZED STEEL",
                            "STANDARD POLISHED BRASS")],
                 TorchJoinChainAggregateExec),
    "q2_regions": ([_q2(r) for r in ("EUROPE", "ASIA")],
                   TorchJoinChainRowsExec),
}


def _tpch_sessions():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for c in (port, ref):
        c.sql(ROWS_ON)
    register_tpch_both(port, ref, sf=0.01, seed=1)
    return port, ref


def _sides(ctx, sql):
    """Every build side of the chains of `sql`, staged anew."""
    return [bi for c in CHAINS for e in _execs(ctx, sql, c)
            for bi in e.stage_builds(ctx.task_context(), compose=False)]


def _masked(bi) -> bool:
    """Whether build side `bi` took an unfiltered table and masked it."""
    return bi.base is not None and bi.table is not bi.base


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_literal_stream_matches_jax_package(monkeypatch, stream):
    """Each literal of the stream, in one session a package, gives the JAX
    package's rows with no fallback. Every eligible filtered side is
    masked once a chain. From the second query on no table of a side over
    a registered table is staged again: the unfiltered tables keep their
    serials, and `chain_build` runs only for the sides the caches cannot
    hold (Q2's subquery aggregate)."""
    sqls, cls = STREAMS[stream]
    assert len(set(sqls)) > 1 and all(s != sqls[0] for s in sqls[1:2])
    port, ref = _tpch_sessions()
    spy = _Spy(monkeypatch, NAMES)
    for i, sql in enumerate(sqls):
        want = ref.sql(sql).to_pydict()
        assert len(next(iter(want.values()))) > 0
        _same_rows(port.sql(sql).to_pydict(), want,
                   ordered="order by" in sql.lower())
        calls = spy.take()
        execs = _execs(port, sql, cls)
        assert execs and all(e.fallbacks == 0 for e in execs)
        tables = {k: v[0][2] for k, v in
                  port.chain_caches.parts["inner"].entries.items()
                  if k[0] == "unfiltered"}
        sides = _sides(port, sql)
        spy.take()
        masked = sum(map(_masked, sides))
        assert masked >= 1 and calls["chain_mask"] == masked
        if i:
            assert calls["chain_build"] == sum(bi.key is None
                                               for bi in sides), (i, calls)
            assert all(before[k] == v for k, v in tables.items()
                       if k in before)
        before = tables


def test_streams_keep_one_unfiltered_table_a_side(monkeypatch):
    """Q3 through the five segments twice: the INNER part keeps one
    unfiltered entry for customer and one for orders throughout."""
    port, ref = _tpch_sessions()
    sqls, _cls = STREAMS["q3_segments"]
    for sql in sqls + sqls:
        _same_rows(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict(),
                   ordered=True)
        keys = list(port.chain_caches.parts["inner"].entries)
        assert len(keys) == 2 and all(k[0] == "unfiltered" for k in keys)


def _agg(lim):
    return AGG.replace(" GROUP BY", f" WHERE d.x < {lim} GROUP BY")


def test_cache_parity_with_jax_package(monkeypatch):
    """Literals A, B, A on `test_torch_memory.py`'s `d`: the port's INNER
    part and the JAX package's `_LUT_CACHE` each hold one entry for the
    side; `chain_build` runs once across the three runs and `chain_mask`
    once a run; the rows are the JAX package's."""
    ref_djc._LUT_CACHE.clear()
    ref_djc._LUT_CACHE_BYTES[0] = 0
    port, ref = _sessions(_tables())
    spy = _Spy(monkeypatch, NAMES)
    builds = 0
    for lim in (3, 1, 3):
        _same_rows(port.sql(_agg(lim)).to_pydict(),
                   ref.sql(_agg(lim)).to_pydict(), ordered=False)
        calls = spy.take()
        builds += calls["chain_build"]
        assert calls["chain_mask"] == 1
    assert builds == 1
    inner = port.chain_caches.parts["inner"].entries
    assert len(inner) == 1 and next(iter(inner))[0] == "unfiltered"
    assert len(ref_djc._LUT_CACHE) == 1


def test_masked_composition_is_keyed_by_the_predicate(monkeypatch):
    """The identity trap: Q5's region side is eligible and filtered, and
    its hop composes into nation. ASIA, EUROPE, ASIA give the JAX
    package's rows (EUROPE's differ from ASIA's); EUROPE stages its own
    words, and the second ASIA reuses the first's (no `chain_stage`)."""
    port, ref = _tpch_sessions()
    sqls, _cls = STREAMS["q5_regions"]
    spy = _Spy(monkeypatch, NAMES)
    rows, stages, counts = [], [], []
    for sql in sqls:
        got = port.sql(sql).to_pydict()
        _same_rows(got, ref.sql(sql).to_pydict(), ordered=True)
        rows.append(got)
        stages.append(spy.take()["chain_stage"])
        counts.append(sum(k[0] == "compose" for k in
                          port.chain_caches.parts["cmp"].entries))
    assert rows[0] != rows[1] and rows[0] == rows[2]
    assert stages == [1, 1, 0]
    (ex,) = _execs(port, sqls[0], TorchJoinChainAggregateExec)
    staged = ex.stage_builds(port.task_context(), compose=False)
    region = [h for h, bi in enumerate(staged)
              if _masked(bi) and bi.batch.num_rows == 5]
    assert region
    composed, _folded = ex.compose_plan(staged)
    assert set(region) <= set(composed)
    assert counts[1] > counts[0] and counts[2] == counts[1]


# --- sides that take no unfiltered table keep their per-predicate tables -------

def _ineligible_tables(case):
    """`test_torch_memory.py`'s tables with `d` replaced: keys spaced so
    that the span passes 16 x the rows ("wide"), or each key twice with `x`
    telling the copies apart, unique only under `d.x < 1` or `d.x >= 1`
    ("unique_under_predicate")."""
    tables = _tables()
    d = tables["d"]
    if case == "wide":
        tables["d"] = {"k": d["k"] * 40, "w": d["w"], "x": d["x"]}
        tables["f"] = dict(tables["f"], k=tables["f"]["k"] * 40)
    else:
        tables["d"] = {"k": np.concatenate([d["k"], d["k"]]),
                       "w": np.concatenate([d["w"], (d["w"] + 1) % 9]),
                       "x": np.repeat([0, 1], len(d["k"]))}
        tables["h"] = {"s": np.arange(7), "y": np.arange(7) % 3}
    return tables


# a side of duplicate keys is planned as a chain hop only beside another
# INNER hop (a single INNER join needs a provably unique key)
UNIQUE_UNDER = ("SELECT w, sum(v) s FROM f JOIN d ON f.k = d.k "
                "JOIN h ON f.s = h.s WHERE d.x {} GROUP BY w")


@pytest.mark.parametrize("case", ["wide", "unique_under_predicate"])
def test_ineligible_side_builds_each_literal(monkeypatch, case):
    """A side the reference does not stage as an unfiltered table (its
    `_unfiltered_lut` returns None) keeps a table a predicate: another
    literal builds again, the first again finds its table, nothing is
    masked, and the rows are the JAX package's. Its unfiltered key is
    remembered as ineligible, and the JAX package's `_LUT_CACHE` stays
    empty."""
    ref_djc._LUT_CACHE.clear()
    ref_djc._LUT_CACHE_BYTES[0] = 0
    port, ref = _sessions(_ineligible_tables(case))
    spy = _Spy(monkeypatch, NAMES)
    sql = {"wide": _agg, "unique_under_predicate":
           lambda lim: UNIQUE_UNDER.format("< 1" if lim == 3 else ">= 1")
           }[case]
    builds = []
    for lim in (3, 1, 3):
        want = ref.sql(sql(lim)).to_pydict()
        assert len(next(iter(want.values()))) > 0
        _same_rows(port.sql(sql(lim)).to_pydict(), want, ordered=False)
        calls = spy.take()
        assert calls["chain_mask"] == 0
        builds.append(calls["chain_build"])
    # the first run also stages the unfiltered attempt (a range pass that
    # finds the span too wide, or a table with a duplicate key), and `h`
    assert builds == ([2, 1, 0] if case == "wide" else [3, 1, 0])
    caches = port.chain_caches
    assert list(caches.ineligible.values()) == [
        "span" if case == "wide" else "duplicate"]
    n_rows = len(_ineligible_tables(case)["d"]["k"])
    assert all(k[3] != n_rows for k in caches.parts["inner"].entries
               if k[0] == "unfiltered")
    assert len(ref_djc._LUT_CACHE) == (0 if case == "wide" else 1)
    (ex,) = _execs(port, sql(3), TorchJoinChainAggregateExec)
    assert ex.fallbacks == 0


def test_side_without_predicate_shares_the_unfiltered_table(monkeypatch):
    """A side with no build predicate takes the unfiltered table as it is
    (no mask), and a later query over the same side with a predicate masks
    that same table: one `chain_build` for both."""
    port, ref = _sessions(_tables())
    spy = _Spy(monkeypatch, NAMES)
    for sql, masks in ((AGG, 0), (_agg(3), 1)):
        _same_rows(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict(),
                   ordered=False)
        calls = spy.take()
        assert calls["chain_mask"] == masks
        assert calls["chain_build"] == (1 if sql == AGG else 0)
    assert len(port.chain_caches.parts["inner"].entries) == 1
