"""The join chain's cross-query device caches and MemoryPool accounting in
the port, held against the JAX package.

The JAX package keeps its chain's staged tables, composed words and fold
records in module-level LRU caches (`device_join_chain.py:67-104`) and
charges each build batch, then the caches' bytes, to the query's
MemoryPool (`:550-551`, `:585`, `_account_device_caches` `:147`); its
fanout-N join-aggregate charges its build batch (`device_join_agg.py:
183-187`). The port keeps the same caches per session
(`SessionContext.chain_caches`, a `ChainCaches`) and charges the same
bytes.
Both packages get the same seeded numpy tables (`f` and `d` as in
`test_memory.py`'s cache test, plus a SEMI and a min/max case); the port
runs on the CPU, where its kernels run their plain versions.
"""
import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.runtime import RuntimeEnv as RefRuntime
from datafusion_tpu.runtime.memory import GreedyMemoryPool as RefPool
from datafusion_tpu_torch.common.errors import ResourcesExhausted
from datafusion_tpu_torch.physical.plan import device_join_agg as dja
from datafusion_tpu_torch.physical.plan import device_join_chain as djc
from datafusion_tpu_torch.physical.plan.device_join_agg import (
    TorchJoinAggregateExec)
from datafusion_tpu_torch.physical.plan.device_join_chain import (
    TorchJoinChainAggregateExec, TorchJoinChainRowsExec)
from datafusion_tpu_torch.runtime import RuntimeEnv
from datafusion_tpu_torch.runtime.memory import (GreedyMemoryPool,
                                                 MemoryReservation)

CPU = torch.device("cpu")
ROWS_ON = "SET datafusion.tpu.device_join_rows_min_spine = 1"
MIB = 1 << 20

AGG = "SELECT w, sum(v) s FROM f JOIN d ON f.k = d.k GROUP BY w"
SEMI = ("SELECT w, count(*) c FROM f JOIN d ON f.k = d.k WHERE EXISTS "
        "(SELECT 1 FROM g WHERE g.k = f.k) GROUP BY w")
MMX = ("SELECT w, count(*) c FROM f JOIN d ON f.k = d.k WHERE EXISTS "
       "(SELECT 1 FROM g WHERE g.k = f.k AND g.s <> f.s) GROUP BY w")
ROWS = "SELECT f.v, d.w FROM f JOIN d ON f.k = d.k WHERE d.w < 3"
FANOUT = "SELECT e.w, sum(f.v) s FROM f JOIN e ON f.k = e.k GROUP BY e.w"

QUERIES = {"agg": (AGG, TorchJoinChainAggregateExec),
           "semi": (SEMI, TorchJoinChainAggregateExec),
           "mmx": (MMX, TorchJoinChainAggregateExec),
           "rows": (ROWS, TorchJoinChainRowsExec),
           "fanout": (FANOUT, TorchJoinAggregateExec)}


def _tables(seed: int = 0, n: int = 30_000):
    """`f` and `d` as in `test_memory.py`'s cache test, with `s`, `x` and
    the SEMI side `g` (keys repeated, a supplier each) and the fanout-4
    side `e`."""
    rng = np.random.default_rng(seed)
    f = {"k": np.sort(rng.integers(0, 5000, n)),
         "v": rng.integers(0, 50, n).astype(np.int64),
         "s": rng.integers(0, 7, n).astype(np.int64)}
    d = {"k": np.arange(5000), "w": rng.integers(0, 9, 5000),
         "x": rng.integers(0, 4, 5000)}
    gk = rng.integers(0, 5000, 8000)
    g = {"k": gk, "s": rng.integers(0, 7, len(gk)).astype(np.int64)}
    e = {"k": np.repeat(np.arange(0, 5000, 3), 4),
         "w": rng.integers(0, 5, 4 * len(range(0, 5000, 3)))}
    return {"f": f, "d": d, "g": g, "e": e}


def _sessions(tables, port_pool=None, ref_pool=None):
    port = dft.SessionContext(CPU, runtime=None if port_pool is None else
                              RuntimeEnv(memory_pool=port_pool))
    ref = df.SessionContext(runtime=None if ref_pool is None else
                            RefRuntime(memory_pool=ref_pool))
    for c in (port, ref):
        c.sql(ROWS_ON)
        for name, cols in tables.items():
            c.register_arrays(name, cols)
    return port, ref


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _execs(ctx, sql, cls):
    return [n for n in _walk(ctx.sql(sql).create_physical_plan())
            if type(n) is cls]


# The JAX package's device chain miscounts MMX on these tables (w = 3: 2479
# rows where numpy, its own host plan and the port count 2482, for every
# seed tried), so the port's MMX rows are held to the JAX package's host
# plan.
HOST_HELD = {MMX}


def _want(ref, sql, tables):
    """The JAX package's rows of `sql`: its device path's, or for a query
    of HOST_HELD its host plan's (device aggregates off)."""
    if sql not in HOST_HELD:
        return ref.sql(sql).to_pydict()
    host = df.SessionContext()
    host.sql("SET datafusion.tpu.device_aggregate = false")
    for name, cols in tables.items():
        host.register_arrays(name, cols)
    return host.sql(sql).to_pydict()


def _rows(out):
    cols = list(out)
    return sorted(zip(*(out[c] for c in cols))), cols


def _same(got, want):
    assert _rows(got) == _rows(want)


def _caches(ctx) -> djc.ChainCaches:
    return ctx.chain_caches


class _Spy:
    """Counts the calls of `chain_build` and `chain_stage` (or of `names`)
    that the port's chain execs make."""

    def __init__(self, monkeypatch, names=("chain_build", "chain_stage")):
        self.calls = {name: 0 for name in names}
        for name in self.calls:
            real = getattr(djc, name)

            def spy(*a, _real=real, _name=name, **k):
                self.calls[_name] += 1
                return _real(*a, **k)
            monkeypatch.setattr(djc, name, spy)

    def take(self):
        out = dict(self.calls)
        for k in self.calls:
            self.calls[k] = 0
        return out


def _build_bytes(monkeypatch, tables, sql):
    """The bytes each package charges a "[build]" reservation for the
    query's build batches, its caches' accounting left out: (JAX
    package's, port's)."""
    import datafusion_tpu.runtime as ref_runtime
    from datafusion_tpu.physical.plan import device_join_chain as ref_djc
    got = {"ref": 0, "port": 0}

    def recorder(base, side):
        class Recording(base):
            def try_grow(self, additional):
                if self.name.endswith("[build]"):
                    got[side] += additional
                super().try_grow(additional)
        return Recording
    with monkeypatch.context() as mp:
        mp.setattr(ref_runtime, "MemoryReservation",
                   recorder(ref_runtime.MemoryReservation, "ref"))
        mp.setattr(ref_djc, "_account_device_caches", lambda *a: None)
        rec = recorder(MemoryReservation, "port")
        mp.setattr(djc, "MemoryReservation", rec)
        mp.setattr(dja, "MemoryReservation", rec)
        mp.setattr(djc, "_account_device_caches", lambda *a: None)
        port, ref = _sessions(tables)
        port.sql(sql).to_pydict()
        ref.sql(sql).to_pydict()
    return got["ref"], got["port"]


# --- (a) build reservations ----------------------------------------------------

@pytest.mark.parametrize("room", ["short", "enough"])
@pytest.mark.parametrize("case", list(QUERIES))
def test_build_reservations_match_jax_package(monkeypatch, case, room):
    """A GreedyMemoryPool one byte short of the JAX package's build
    batches makes both packages raise ResourcesExhausted (the port with no
    fallback); one MiB more and both give the same rows. The port charges
    the same bytes."""
    sql, cls = QUERIES[case]
    tables = _tables()
    ref_bytes, port_bytes = _build_bytes(monkeypatch, tables, sql)
    assert ref_bytes > 0 and port_bytes == ref_bytes
    size = ref_bytes - 1 if room == "short" else ref_bytes + MIB
    port, ref = _sessions(tables, GreedyMemoryPool(size), RefPool(size))
    (ex,) = _execs(port, sql, cls)
    from datafusion_tpu.common.errors import \
        ResourcesExhausted as RefExhausted
    if room == "short":
        with pytest.raises(RefExhausted):
            ref.sql(sql).to_pydict()
        with pytest.raises(ResourcesExhausted):
            port.sql(sql).to_pydict()
        assert ex.fallbacks == 0
    else:
        got = ref.sql(sql).to_pydict()
        _same(port.sql(sql).to_pydict(), _want(ref, sql, tables))
        assert ex.fallbacks == 0
        if sql not in HOST_HELD:
            _same(got, _want(ref, sql, tables))


# --- (b) the caches' accounting evicts and never raises -------------------------

def test_device_lut_caches_under_memory_pool():
    """The port of `test_memory.py`'s `test_device_lut_caches_under_memory_
    pool`: after a warm query, accounting the caches against a pool of half
    their bytes evicts and does not raise, the pool holds at most its size,
    and the query then answers as before (the JAX package's rows)."""
    port, ref = _sessions(_tables())
    expected = port.sql(AGG + " ORDER BY w").to_pydict()
    caches = _caches(port)
    before = caches.device_cache_bytes()
    assert before > 0, "chain staging should have populated the caches"
    pool = GreedyMemoryPool(before // 2)
    res = MemoryReservation("test[cache-account]", pool)
    djc._account_device_caches(res, caches)
    assert caches.device_cache_bytes() < before, "expected LRU eviction"
    assert pool.reserved() <= before // 2
    res.free()
    got = port.sql(AGG + " ORDER BY w").to_pydict()
    assert got == expected == ref.sql(AGG + " ORDER BY w").to_pydict()


def test_accounting_with_nothing_to_evict_runs_unaccounted():
    """A pool too small for even one entry: the caches empty out and the
    accounting returns without raising; a pool with room charges them
    whole."""
    port, _ref = _sessions(_tables())
    port.sql(MMX).to_pydict()
    caches = _caches(port)
    total = caches.device_cache_bytes()
    res = MemoryReservation("test", GreedyMemoryPool(1))
    djc._account_device_caches(res, caches)
    assert caches.device_cache_bytes() == 0 and res.size == 0
    port.sql(MMX).to_pydict()
    assert caches.device_cache_bytes() == total
    pool = GreedyMemoryPool(total)
    res = MemoryReservation("test", pool)
    djc._account_device_caches(res, caches)
    assert pool.reserved() == total == caches.device_cache_bytes()


def test_evict_takes_the_largest_part_first():
    port, _ref = _sessions(_tables())
    for sql in (AGG, MMX):
        port.sql(sql).to_pydict()
    caches = _caches(port)
    sizes = {k: p.nbytes for k, p in caches.parts.items()}
    largest = max(sizes, key=sizes.get)
    freed = caches.evict_device_caches(caches.device_cache_bytes() - 1)
    assert freed > 0
    assert caches.parts[largest].nbytes < sizes[largest]
    assert all(caches.parts[k].nbytes == v for k, v in sizes.items()
               if k != largest)


# --- (c) a warm re-run stages nothing ----------------------------------------------

@pytest.mark.parametrize("case", ["agg", "semi", "mmx", "rows"])
def test_warm_rerun_stages_nothing(monkeypatch, case):
    """The first run of a chain over registered tables calls `chain_build`
    (and `chain_stage` where it composes or folds); a warm re-run calls
    neither and gives the JAX package's rows."""
    sql, _cls = QUERIES[case]
    tables = _tables()
    port, ref = _sessions(tables)
    spy = _Spy(monkeypatch)
    want = _want(ref, sql, tables)
    _same(port.sql(sql).to_pydict(), want)
    cold = spy.take()
    assert cold["chain_build"] >= 1
    for _ in range(2):
        _same(port.sql(sql).to_pydict(), want)
        assert spy.take() == {"chain_build": 0, "chain_stage": 0}


def test_warm_fold_reads_no_stats(monkeypatch):
    """A warm chain whose tables all hit reads no stats back: `_plan_stats`
    queues nothing on the card (its `_any_duplicate` is not called)."""
    port, _ref = _sessions(_tables())
    sql = AGG.replace("JOIN d ON f.k = d.k", "JOIN d ON f.k = d.k AND d.x < 3")
    port.sql(sql).to_pydict()
    calls = []
    real = djc._any_duplicate
    monkeypatch.setattr(djc, "_any_duplicate",
                        lambda v: calls.append(1) or real(v))
    port.sql(sql).to_pydict()
    assert calls == []


# --- (d) misses ----------------------------------------------------------------------

def test_reregistered_table_misses(monkeypatch):
    """A table registered anew misses and gives its new rows."""
    tables = _tables()
    port, ref = _sessions(tables)
    port.sql(AGG).to_pydict()
    d = dict(tables["d"])
    d["w"] = (d["w"] + 3) % 11
    for c in (port, ref):
        c.register_arrays("d", d)
    spy = _Spy(monkeypatch)
    _same(port.sql(AGG).to_pydict(), ref.sql(AGG).to_pydict())
    assert spy.take()["chain_build"] == 1


@pytest.mark.parametrize("form", ["literal", "parameter"])
def test_build_predicate_literal_misses(monkeypatch, form):
    """The same build predicate with another literal gives its own rows
    from the one unfiltered table of `d` that the session keeps, as the
    JAX package keeps one in its `_LUT_CACHE`: `chain_build` runs in the
    first run only, and every run masks the table once (`chain_mask`). A
    prepared statement run with another parameter gives its own rows too;
    EXECUTE, a statement that may change the catalog, clears the caches as
    it clears the cached plans, so each EXECUTE stages the table anew."""
    port, ref = _sessions(_tables())
    if form == "parameter":
        for c in (port, ref):
            c.sql("PREPARE q(BIGINT) AS " + ROWS.replace("d.w < 3",
                                                        "d.w < $1"))
    spy = _Spy(monkeypatch, ("chain_build", "chain_mask"))
    for i, lim in enumerate((3, 6, 3)):
        sql = ROWS.replace("d.w < 3", f"d.w < {lim}") \
            if form == "literal" else f"EXECUTE q({lim})"
        _same(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict())
        staged = 1 if i == 0 or form == "parameter" else 0
        assert spy.take() == {"chain_build": staged, "chain_mask": 1}
    assert len(_caches(port).parts["inner"].entries) == 1


def test_different_payload_reads_get_different_folds(monkeypatch):
    """Two queries over the same build whose walks read different payload
    columns share the table and get a fold each."""
    port, ref = _sessions(_tables())
    spy = _Spy(monkeypatch)
    by_x = AGG.replace("SELECT w", "SELECT x").replace("BY w", "BY x")
    _same(port.sql(AGG).to_pydict(), ref.sql(AGG).to_pydict())
    assert spy.take() == {"chain_build": 1, "chain_stage": 1}
    _same(port.sql(by_x).to_pydict(), ref.sql(by_x).to_pydict())
    assert spy.take() == {"chain_build": 0, "chain_stage": 1}
    folds = [k for k in _caches(port).parts["cmp"].entries
             if k[0] == "fold"]
    assert len(folds) == 2 and folds[0] != folds[1]
    for sql in (AGG, by_x):
        _same(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict())
    assert spy.take() == {"chain_build": 0, "chain_stage": 0}


# --- (e) LRU order and the caps -------------------------------------------------------

def test_lru_part_keeps_the_newest_entry():
    part = djc._LruPart(max_entries=3, max_bytes=100)
    for k, nbytes in (("a", 10), ("b", 20), ("c", 30)):
        part.put(k, k, nbytes)
    assert part.get("a") == "a"            # now the newest
    part.put("d", "d", 5)                  # the entry cap evicts "b"
    assert list(part.entries) == ["c", "a", "d"] and part.nbytes == 45
    part.put("e", "e", 70)                 # the byte cap evicts "c"
    assert list(part.entries) == ["a", "d", "e"] and part.nbytes == 85
    part.put("f", "f", 500)                # larger than the cap: kept alone
    assert list(part.entries) == ["f"] and part.nbytes == 500


def test_session_caps_evict_oldest_tables(monkeypatch):
    """With caps of two INNER tables, three chains over three build tables
    keep the last two; with a byte cap below one table the newest table
    is still kept, alone."""
    monkeypatch.setattr(djc, "_LUT_CACHE_MAX", 2)
    tables = _tables()
    for i in (1, 2, 3):
        tables[f"d{i}"] = {"k": tables["d"]["k"],
                           "w": (tables["d"]["w"] + i) % 9}
    port, ref = _sessions(tables)
    keys = []
    for i in (1, 2, 3):
        sql = AGG.replace("JOIN d ON f.k = d.k", f"JOIN d{i} d ON f.k = d.k")
        _same(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict())
        keys.append(list(_caches(port).parts["inner"].entries)[-1])
    assert list(_caches(port).parts["inner"].entries) == keys[1:]
    monkeypatch.setattr(djc, "_LUT_CACHE_MAX_BYTES", 1)
    port, ref = _sessions(tables)
    for i in (1, 2):
        sql = AGG.replace("JOIN d ON f.k = d.k", f"JOIN d{i} d ON f.k = d.k")
        _same(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict())
        inner = _caches(port).parts["inner"]
        assert len(inner.entries) == 1 and inner.nbytes > 1


# --- (f) nothing cached is written -----------------------------------------------------

def _cached_tensors(caches):
    out = []
    for part in caches.parts.values():
        for key, (value, _n) in part.entries.items():
            if isinstance(value, tuple):            # (table, stats, serial)
                ts = value[0].tensors()
            elif isinstance(value, torch.Tensor):   # an owner's words
                ts = [value]
            else:                                   # a Fold
                ts = [t for t in (value.records, value.valid)
                      if t is not None]
            out += [(key, i, t) for i, t in enumerate(ts)]
    return out


def test_cached_tensors_are_never_written():
    """Every cached tensor, cloned after a first run, is unchanged after a
    second and a third query over the same builds."""
    port, _ref = _sessions(_tables())
    port.sql(MMX).to_pydict()
    port.sql(AGG).to_pydict()
    cached = [(k, i, t, t.clone()) for k, i, t in
              _cached_tensors(_caches(port))]
    assert cached
    port.sql(MMX).to_pydict()
    port.sql(AGG.replace("SELECT w", "SELECT x").replace("BY w", "BY x")
             ).to_pydict()
    for _k, _i, t, copy in cached:
        assert torch.equal(t, copy)


# --- (g) failed tables are not kept ---------------------------------------------------

def test_duplicate_build_is_not_cached():
    """A chain whose first build has a duplicate key (`test_torch_join_
    chain.py`'s `test_nonunique_build_falls_back`) falls back to the host
    plan, gives the JAX package's rows and leaves the caches empty, run
    after run."""
    tables = {"f": {"k": np.array([1, 2, 3, 1] * 500),
                    "v": np.arange(2000, dtype=np.int64)},
              "b1": {"id": np.array([1, 1, 2, 3]),
                     "p": np.array([10, 11, 20, 30])},
              "b2": {"p": np.array([10, 11, 20, 30]),
                     "g": np.array([1, 1, 2, 3])}}
    sql = ("SELECT g, count(*) c FROM f JOIN b1 ON f.k = b1.id "
           "JOIN b2 ON b1.p = b2.p GROUP BY g")
    port, ref = _sessions(tables)
    (ex,) = _execs(port, sql, TorchJoinChainAggregateExec)
    for runs in (1, 2):
        _same(port.sql(sql).to_pydict(), ref.sql(sql).to_pydict())
        assert ex.fallbacks == runs
    assert _caches(port).device_cache_bytes() == 0
    assert all(not p.entries for p in _caches(port).parts.values())


# --- (h) the pool is released -----------------------------------------------------------

@pytest.mark.parametrize("case", ["agg", "fanout"])
def test_pool_released_after_aggregate(case):
    """After an aggregate chain or a join-aggregate query the pool is back
    to 0; a row chain holds its reservation on the exec until its next
    execution, as the JAX package's does."""
    sql, _cls = QUERIES[case]
    pool = GreedyMemoryPool(1 << 40)
    port, _ref = _sessions(_tables(), port_pool=pool)
    port.sql(sql).to_pydict()
    assert pool.reserved() == 0


def test_rows_chain_holds_its_reservation_until_the_next_run():
    pool = GreedyMemoryPool(1 << 40)
    port, _ref = _sessions(_tables(), port_pool=pool)
    (ex,) = _execs(port, ROWS, TorchJoinChainRowsExec)
    port.sql(ROWS).to_pydict()
    held = pool.reserved()
    assert held > 0 and ex._held is not None and ex._held.size == held
    port.sql(ROWS).to_pydict()
    assert pool.reserved() == held


def test_catalog_change_clears_the_caches():
    """Registering a table clears the chain caches with the column cache."""
    port, _ref = _sessions(_tables())
    port.sql(AGG).to_pydict()
    assert _caches(port).device_cache_bytes() > 0
    port.register_arrays("h", {"a": np.arange(3)})
    assert _caches(port).device_cache_bytes() == 0
    assert len(port.device_cache) == 0
