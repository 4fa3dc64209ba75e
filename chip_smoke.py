#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through
`datafusion_tpu_torch.SessionContext(torch.device("cuda"))`. It imports
nothing of JAX, of the JAX package `datafusion_tpu` or of `bench`; every
query is held against a numpy oracle on the same data.

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from `datafusion_tpu_torch/csrc` (one nvcc per
   source, all at once) and prints the build seconds;
3. dense path, TPC-H Q1 over a Q1-shaped lineitem at SF10 (60,012,150
   rows, `make_lineitem`): `fused_dense_aggregate` against its plain
   PyTorch version (int64 lanes exactly; float64 lanes with NULLs and
   NaNs, sums within rel 1e-9), Q1 end to end (warm median of 5) against
   numpy, and TPC-H Q6 (G = 1) end to end against numpy;
4. TPC-H at SF10, made here from a seed by the rules of the port's
   `tpch/datagen.py` (`tpch_tables`: region, nation, 100,000 suppliers,
   1,500,000 customers, 15,000,000 orders, about 60.0M lineitems):
   - hash path: `hash_group_aggregate` against its plain version on Q18's
     and Q15's subqueries (equal group tables), `compact_groups` with
     Q18's HAVING against its plain version (equal), then both subqueries
     end to end against numpy;
   - join chains: `chain_build` against its plain version on every build
     side of Q5 (equal tables) and `chain_aggregate` against its plain
     version on Q5's walk (equal group tables), the same on Q3 (the hash
     fold) and Q4 (the SEMI build over lineitem), then Q3, Q4 and Q5 end
     to end against numpy, each with a breakdown of its time;
   - window functions over the SF10 lineitem (with `l_returnflag`):
     W1 (top 3 by price per supplier beside each order's quantity, a
     WindowExec over two PARTITION BYs), W2 (a global row_number and lag)
     and W3 (a 7-row moving sum in 3 partition runs, a BoundedWindowExec
     over its partition-key sort): `radix_sort`, `gather_lanes` and
     `window_scan` against their plain versions on each window
     evaluation's inputs (equal), then each query end to end against
     numpy, with a breakdown;
5. ClickBench's `UserID`, `SearchPhrase` and `EventTime` at 99,997,497
   rows (the public `hits` row count), drawn as `generate_hits` draws
   them: `group_topk` against its plain version on Q16,
   `hash_group_aggregate` against its plain version on Q17 (42-bit keys:
   the probing table), Q16 and Q17 end to end against numpy; then
   `radix_sort` against its plain version on Q25's and Q27's order words
   over the rows with a search phrase (equal permutations; stable
   `torch.sort` as the yardstick), and Q25, Q26 and Q27 end to end
   against numpy, with a breakdown.

Each end-to-end path sets the launch counts to 0 just before it and reads
them just after; it fails if a kernel of the path was not launched or the
exec fell back to the host (for a window, a function evaluated on the
host). Any failure raises and exits non-zero. The last line is `{"ok": true, "device": {...}}`; the line before it is the
card's name and power limit, and before that one JSON line lists every
kernel with its time, its plain version's time and its bound.
"""
import datetime
import json
import os
import statistics
import subprocess
import sys
import time

SF10_ROWS = 60_012_150       # TPC-H SF10 lineitem, DataFusion's `bench.sh tpch10`
FLOAT_ROWS = 10_000_000
FLOAT_QUERY = ("SELECT g, count(*) c, sum(v) s, avg(v) a, min(v) mn, "
               "max(v) mx FROM t GROUP BY g")
HITS_ROWS = 99_997_497       # the public ClickBench hits.parquet
REPS = 5
WINDOW_REPS = 1              # W1-W3 each gather 60M rows on the host
DEVICE = "cuda"
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 outside the tensor
# cores (the interpreter's 64-bit integer ops have no published peak)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# TPC-H Q1 (the port's `tpch/queries.py` has it too, over the full table)
Q1 = """
select
    l_returnflag, l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""
# TPC-H Q6, Q18's subquery and Q15's revenue0 body
Q6 = """select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1995-01-01'
  and l_discount between 0.05 and 0.07
  and l_quantity < 24"""
Q18_SUB = ("select l_orderkey from lineitem group by l_orderkey "
           "having sum(l_quantity) > 300")
Q15_SUB = """select l_suppkey as supplier_no,
       sum(l_extendedprice * (1 - l_discount)) as total_revenue
from lineitem
where l_shipdate >= date '1996-01-01'
  and l_shipdate < date '1996-04-01'
group by l_suppkey"""
# ClickBench Q16 and Q17 (benchmarks/queries/clickbench/queries.sql)
CB_Q16 = ('SELECT "UserID", COUNT(*) FROM hits GROUP BY "UserID" '
          'ORDER BY COUNT(*) DESC LIMIT 10')
CB_Q17 = ('SELECT "UserID", "SearchPhrase", COUNT(*) FROM hits GROUP BY '
          '"UserID", "SearchPhrase" ORDER BY COUNT(*) DESC LIMIT 10')
# ClickBench Q25-Q27: a top 10 over the rows with a search phrase
CB_SORTS = {
    25: ('SELECT "SearchPhrase" FROM hits WHERE "SearchPhrase" <> \'\' '
         'ORDER BY to_timestamp_seconds("EventTime") LIMIT 10'),
    26: ('SELECT "SearchPhrase" FROM hits WHERE "SearchPhrase" <> \'\' '
         'ORDER BY "SearchPhrase" LIMIT 10'),
    27: ('SELECT "SearchPhrase" FROM hits WHERE "SearchPhrase" <> \'\' '
         'ORDER BY to_timestamp_seconds("EventTime"), "SearchPhrase" '
         'LIMIT 10')}
# Window queries over lineitem. W1: top 3 per group, the shape of TPC-DS
# Q67's rank() ... where rk <= 100, two PARTITION BYs (a WindowExec over
# all rows); W2: a global running row number and previous value, the shape
# of TPC-DS Q51's cumulative window; W3: a moving 7-row sum in 3 partition
# runs (a BoundedWindowExec over its partition-key SortExec).
W1 = ("SELECT l_suppkey, l_orderkey, l_extendedprice, rk, order_qty FROM "
      "(SELECT l_suppkey, l_orderkey, l_extendedprice, rank() OVER "
      "(PARTITION BY l_suppkey ORDER BY l_extendedprice DESC) AS rk, "
      "sum(l_quantity) OVER (PARTITION BY l_orderkey) AS order_qty "
      "FROM lineitem) WHERE rk <= 3")
W2 = ("SELECT l_orderkey, l_shipdate, l_extendedprice, row_number() OVER "
      "(ORDER BY l_shipdate, l_orderkey) AS rn, lag(l_extendedprice) OVER "
      "(ORDER BY l_shipdate, l_orderkey) AS prev_price FROM lineitem")
W3 = ("SELECT l_returnflag, l_shipdate, l_orderkey, sum(l_quantity) OVER "
      "(PARTITION BY l_returnflag ORDER BY l_shipdate, l_orderkey ROWS "
      "BETWEEN 6 PRECEDING AND CURRENT ROW) AS qty7 FROM lineitem")


def days(y, m, d) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def find_exec(plan, cls):
    if isinstance(plan, cls):
        return plan
    for c in plan.children():
        hit = find_exec(c, cls)
        if hit is not None:
            return hit
    return None


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device ms of `fn` over `reps` runs after one warm-up; `setup`
    runs before each, outside the timed window."""
    import torch
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# ---- bounds -----------------------------------------------------------------

def col_bytes(cols, idxs, n: int) -> int:
    """Bytes of `n` rows of the columns `idxs` of `cols` ({index: (data,
    validity)}): each value and each validity byte read once."""
    total = 0
    for i in idxs:
        data, valid = cols[i]
        total += n * (data.element_size() + (valid is not None))
    return total


def prog_ops(spec, n: int) -> int:
    """Interpreter ops of `n` rows: every program's instructions once a
    row (an upper bound for rows that a predicate drops early)."""
    return n * sum(len(p.code) for p in spec.programs())


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes over the HBM rate or ops
    over the float32 rate, whichever is larger."""
    b = nbytes / PEAK_BYTES_PER_S * 1e3
    o = ops / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o
            else "operations", "bytes": int(nbytes), "ops": int(ops)}


def entry(err, ms, plain_ms, bnd, library_ms=None) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "library_ms": library_ms}


# ---- data -------------------------------------------------------------------

def dict_column(pool, codes):
    """A dictionary string column of `pool[codes]`, its dictionary sorted
    as the port's `Dictionary` requires."""
    import numpy as np
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.column import Column, Dictionary
    values = np.asarray(pool, dtype=object)
    order = np.argsort(values.astype(str), kind="stable")
    rank = np.empty(len(order), np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return Column(dt.STRING, rank[np.asarray(codes)], None,
                  Dictionary(values[order]))


def make_batch(cols):
    """A Batch of [(name, column)], no column nullable."""
    from datafusion_tpu_torch.common.batch import Batch
    from datafusion_tpu_torch.common.schema import Field, Schema
    schema = Schema([Field(n, c.dtype, False) for n, c in cols])
    return Batch(schema, [c for _n, c in cols], len(cols[0][1].data_host()))


def make_lineitem(n: int, seed: int = 0):
    """Vectorised SF1-shaped lineitem with exactly Q1's columns."""
    import numpy as np
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.column import Column
    rng = np.random.default_rng(seed)
    dec2 = dt.decimal(15, 2)      # TPC-H money: scaled int64, exact
    qty = (rng.integers(1, 51, n) * 100).astype(np.int64)
    price = rng.integers(90_000, 10_500_000, n).astype(np.int64)
    disc = (rng.integers(0, 11, n)).astype(np.int64)        # 0.00..0.10
    tax = (rng.integers(0, 9, n)).astype(np.int64)          # 0.00..0.08
    ship = rng.integers(8035, 10471, n).astype(np.int32)  # 1992..1998-08 days
    today = 9298  # 1995-06-17
    receipt = ship + rng.integers(1, 31, n)
    # returnflag from receiptdate, linestatus from shipdate (spec): rows with
    # ship <= today < receipt land in the (N, F) group
    rf = np.where(receipt <= today, np.where(rng.random(n) < 0.5, 0, 2), 1)
    ls = np.where(ship > today, 1, 0)   # F=0, O=1
    return make_batch([
        ("l_quantity", Column(dec2, qty)),
        ("l_extendedprice", Column(dec2, price)),
        ("l_discount", Column(dec2, disc)),
        ("l_tax", Column(dec2, tax)),
        ("l_returnflag", dict_column(["A", "N", "R"], rf)),
        ("l_linestatus", dict_column(["F", "O"], ls)),
        ("l_shipdate", Column(dt.DATE, ship))])


def float_batch(n: int, seed: int):
    import numpy as np
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.batch import Batch
    from datafusion_tpu_torch.common.column import Column
    from datafusion_tpu_torch.common.schema import Field, Schema
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 8, n).astype(np.int32)
    v = rng.normal(size=n) * 100
    v[rng.random(n) < 0.01] = np.nan
    valid = rng.random(n) >= 0.01
    schema = Schema([Field("g", dt.STRING, False),
                     Field("v", dt.FLOAT64, True)])
    return Batch(schema, [dict_column(list("abcdefgh"), g),
                          Column(dt.FLOAT64, v, valid)], n)


def tpch_tables(sf: int, seed: int):
    """The TPC-H tables by the rules of the port's `tpch/datagen.py:98-257`,
    vectorised, with the columns that Q3, Q4, Q5, Q15, Q18 and W1-W3 read:
    `o_orderkey` is 4i - 3 and `l_orderkey` repeats it 1-7 times (so it is
    sorted), foreign keys are uniform, `l_suppkey` is one of the 4
    suppliers of a uniform part, money is Decimal(15,2), dates are Date32,
    `c_mktsegment`, `o_orderpriority`, `n_name`, `r_name` and
    `l_returnflag` (`datagen.py:223`, drawn after the other columns) are
    dictionary strings. Returns {table: Batch}."""
    import numpy as np
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.column import Column
    from datafusion_tpu_torch.tpch import datagen as G
    rng = np.random.default_rng(seed)
    n_supp, n_part = int(10_000 * sf), int(200_000 * sf)
    n_cust, n_ord, per_part = int(150_000 * sf), int(1_500_000 * sf), 4
    i64, dec2 = dt.INT64, dt.decimal(15, 2)
    out = {
        "region": make_batch([
            ("r_regionkey", Column(i64, np.arange(5, dtype=np.int64))),
            ("r_name", dict_column(G._REGIONS, np.arange(5)))]),
        "nation": make_batch([
            ("n_nationkey", Column(i64, np.arange(25, dtype=np.int64))),
            ("n_name", dict_column([n for n, _ in G._NATIONS],
                                   np.arange(25))),
            ("n_regionkey", Column(i64, np.array(
                [r for _, r in G._NATIONS], np.int64)))]),
        "supplier": make_batch([
            ("s_suppkey", Column(i64, np.arange(1, n_supp + 1,
                                                dtype=np.int64))),
            ("s_nationkey", Column(i64, rng.integers(0, 25, n_supp)))]),
        "customer": make_batch([
            ("c_custkey", Column(i64, np.arange(1, n_cust + 1,
                                                dtype=np.int64))),
            ("c_nationkey", Column(i64, rng.integers(0, 25, n_cust))),
            ("c_mktsegment", dict_column(G._SEGMENTS,
                                         rng.integers(0, 5, n_cust)))]),
    }
    ok = np.arange(1, n_ord + 1, dtype=np.int64) * 4 - 3
    o_date = rng.integers(G._days(1992, 1, 1), G._days(1998, 8, 2) - 151,
                          n_ord).astype(np.int32)
    out["orders"] = make_batch([
        ("o_orderkey", Column(i64, ok)),
        ("o_custkey", Column(i64, rng.integers(1, n_cust + 1, n_ord))),
        ("o_orderdate", Column(dt.DATE, o_date)),
        ("o_orderpriority", dict_column(G._PRIORITIES,
                                        rng.integers(0, 5, n_ord))),
        ("o_shippriority", Column(dt.INT32, np.zeros(n_ord, np.int32)))])
    n_lines = rng.integers(1, 8, n_ord)
    l_odate = np.repeat(o_date, n_lines)
    n = len(l_odate)
    part = rng.integers(1, n_part + 1, n).astype(np.int64)
    which = rng.integers(0, per_part, n)
    supp = ((part - 1 + which * (n_supp // per_part + 1)) % n_supp) + 1
    qty = rng.integers(1, 51, n).astype(np.int64)
    price = np.rint(qty * (90000 + (part % 20001) / 10 +
                           100 * (part % 1000))).astype(np.int64)
    del part, which
    ship = (l_odate + rng.integers(1, 122, n)).astype(np.int32)
    commit = (l_odate + rng.integers(30, 91, n)).astype(np.int32)
    receipt = (ship + rng.integers(1, 31, n)).astype(np.int32)
    del l_odate
    out["lineitem"] = make_batch([
        ("l_orderkey", Column(i64, np.repeat(ok, n_lines))),
        ("l_suppkey", Column(i64, supp)),
        ("l_quantity", Column(dec2, qty * 100)),
        ("l_extendedprice", Column(dec2, price)),
        ("l_discount", Column(dec2, rng.integers(0, 11, n))),
        ("l_shipdate", Column(dt.DATE, ship)),
        ("l_commitdate", Column(dt.DATE, commit)),
        ("l_receiptdate", Column(dt.DATE, receipt)),
        ("l_returnflag", dict_column(["A", "N", "R"], np.where(
            receipt <= G._days(1995, 6, 17),
            np.where(rng.random(n) < 0.5, 2, 0), 1)))])
    return out


def hits(n: int, seed: int = 0):
    """`UserID` and `SearchPhrase` as `generate_hits` draws them (its first
    three draws: zipf(1.3), random, zipf(1.5); `clickbench/workload.py:
    15-26`), with the dictionary sorted as `register_hits` sorts it, and
    then `EventTime` as it draws it (`:81`: 2013-07-01 plus up to 31 days
    of seconds)."""
    import numpy as np
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.column import Column
    rng = np.random.default_rng(seed)
    n_users = max(n // 6, 10)
    user = (rng.zipf(1.3, n) % n_users).astype(np.int64)
    n_phrases = max(n // 800, 997)
    phrases = np.concatenate([
        np.array([""], dtype=object),
        np.char.add("search phrase ",
                    np.arange(n_phrases).astype(str)).astype(object)])
    idx = np.where(rng.random(n) < 0.6, 0,
                   rng.zipf(1.5, n) % len(phrases)).astype(np.int32)
    event = (1372636800 + rng.integers(0, 31 * 86400, n)).astype(np.int64)
    return make_batch([("UserID", Column(dt.INT64, user)),
                       ("SearchPhrase", dict_column(phrases, idx)),
                       ("EventTime", Column(dt.INT64, event))])


def col(batch, name):
    return batch.column_by_name(name).data_host()


# ---- the main path ----------------------------------------------------------

def run_path(ctx, sql, expect, card, label, rows, cls=None, reps=REPS):
    """The main path: launch counts set to 0, a warm-up and `reps` timed
    runs, counts read. Fails unless every kernel of `expect` launched and
    no exec of `cls` (by default TorchGroupAggregateExec) fell back.
    Returns (result batch, launches, ms)."""
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    cls = cls or TorchGroupAggregateExec
    kernels.reset_launch_counts()
    out = ctx.sql(sql).collect_batch()                # warm-up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = ctx.sql(sql).collect_batch()
        times.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    # the plan is cached: this is the exec that ran
    ex = find_exec(ctx.sql(sql).create_physical_plan(), cls)
    fallbacks = getattr(ex, "fallbacks", 0)
    if ex is None or fallbacks != 0:
        raise AssertionError(f"{label} fell back to the host")
    if getattr(ex, "device", ctx.device) != ctx.device:
        raise AssertionError(f"{label}: {type(ex).__name__} has no device")
    missing = [k for k in expect if launches[k] < 1]
    if missing:
        raise AssertionError(f"{label} did not launch {missing}")
    med = statistics.median(times) * 1e3
    per_query = {k: launches[k] / (reps + 1) for k in expect}
    print(f"{label} end to end: warm median of {reps} {med:.3f} ms, "
          f"{rows / (med / 1e3):.1f} rows/s, launches per query "
          f"{per_query}, fallbacks {fallbacks} [{card}]", flush=True)
    return out, launches, med


def breakdown(ctx, sql, card, label, cls=None, main=None, host=None):
    """Where one warm run's time goes: for a grouped aggregate the host
    scan of the key columns' bounds (host clock; `host` names other host
    work measured by the caller); per span of the exec (`dft.*`, host
    time, which waits for the card where a span reads a result back) and
    per kernel (device time) from torch.profiler. The idle share needs
    the trace to hold a kernel whose name contains `main`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    cls = cls or TorchGroupAggregateExec
    ex = find_exec(ctx.sql(sql).create_physical_plan(), cls)
    bounds = host or "in dft.compile"
    if cls is TorchGroupAggregateExec:
        batches = ex.input_batches(ctx.task_context())
        t0 = time.perf_counter()
        for e, _n in ex.group_exprs:
            ex._phys_int_bounds(e, batches)
        bounds = f"{(time.perf_counter() - t0) * 1e3:.3f} ms host"
    ctx.sql(sql).collect_batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.sql(sql).collect_batch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, device = {}, {}
    for ev in prof.key_averages():
        if ev.key.startswith("dft.") and ev.device_type == DeviceType.CPU:
            spans[ev.key] = round(ev.cpu_time_total / 1e3, 3)
        elif getattr(ev, "device_type", None) == DeviceType.CUDA and \
                not ev.key.startswith("dft."):
            us = getattr(ev, "self_device_time_total", 0)
            key = ev.key.replace("(anonymous namespace)::", "")
            device[key.split("(")[0][-48:]] = round(us / 1e3, 3)
    busy = sum(device.values())
    # a trace that lost the fold kernel's event cannot give the share
    main = main or ("chain_" if cls is not TorchGroupAggregateExec else
                    "aggregate_kernel")
    whole = any(main in k for k in device)
    print(f"{label} breakdown (one warm run, {wall:.3f} ms wall): "
          f"{'host' if host else 'key-bounds scan'} {bounds}; spans ms "
          f"{spans}; device ms {device}; "
          f"device busy {busy:.3f} ms, idle share "
          f"{(1 - busy / wall) if whole else 'not measured'} [{card}]",
          flush=True)


# ---- kernels against their plain versions -----------------------------------

def kernel_vs_plain(ctx, sql, table_name, float_rel):
    """Kernel and plain version of the query's dense aggregate on the same
    staged inputs. Returns the kernel's report entry."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        LANE_SUM_F64, dense_group_aggregate, dense_group_aggregate_plain)
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    ex = find_exec(ctx.sql(sql).create_physical_plan(),
                   TorchGroupAggregateExec)
    if ex is None:
        raise AssertionError(f"no TorchGroupAggregateExec for {table_name}")
    (batch,) = ex.input_batches(ctx.task_context())
    spec, _plan, _names, _slots = ex.compile([batch])
    cols, aux = ex.stage(spec, batch)
    n = batch.num_rows
    dev = ctx.device
    got = dense_group_aggregate(spec, cols, aux, n, spec.new_table(dev))
    want = dense_group_aggregate_plain(spec, cols, aux, n,
                                       spec.new_table(dev))
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if not np.array_equal(g[0], w[0]):
        raise AssertionError(f"{table_name}: row counts differ")
    err = 0.0
    for i, (a, b) in enumerate(zip(spec.lane_arrays(g), spec.lane_arrays(w))):
        if spec.lanes[i][1] == LANE_SUM_F64:   # atomics reorder the adds
            ok = np.allclose(a, b, rtol=float_rel, atol=0, equal_nan=True)
            err = max(err, float(np.nanmax(np.abs(a - b), initial=0.0)))
        else:
            ok = np.array_equal(a, b, equal_nan=a.dtype == np.float64)
            if a.dtype != np.float64:
                err = max(err, float(np.max(np.abs(a - b), initial=0)))
        if not ok:
            raise AssertionError(f"{table_name}: lane {i} differs:\n{a}\n{b}")
    t_k = spec.new_table(dev)
    ms = cuda_ms(lambda: dense_group_aggregate(spec, cols, aux, n, t_k), 20)
    t_p = spec.new_table(dev)
    plain_ms = cuda_ms(
        lambda: dense_group_aggregate_plain(spec, cols, aux, n, t_p), 3)
    bnd = bound(col_bytes(cols, spec.pools.columns, n) + t_k.numel() * 8,
                prog_ops(spec, n))
    return entry(err, ms, plain_ms, bnd)


def hash_kernel_vs_plain(ctx, sql, label, card, having=False):
    """`hash_group_aggregate` against its plain version on the query's
    staged inputs (equal group tables, ordered by key), and with `having`
    `compact_groups` with the query's HAVING against its plain version
    (equal, column for column). Returns (kernel 2's report entry, kernel
    3's or None, the kernel's table, spec, lane names)."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        compact_groups, compact_groups_plain, hash_group_aggregate,
        hash_group_aggregate_plain)
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    ex = find_exec(ctx.sql(sql).create_physical_plan(),
                   TorchGroupAggregateExec)
    (batch,) = ex.input_batches(ctx.task_context())
    spec, plan, names, slot_map = ex.compile([batch])
    cols, aux = ex.stage(spec, batch)
    n, dev = batch.num_rows, ctx.device
    tables = []
    for fold in (hash_group_aggregate, hash_group_aggregate_plain):
        table = spec.new_table(dev)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        fold(spec, cols, aux, n, table, overflow)
        torch.cuda.synchronize()
        if int(overflow.item()):
            raise AssertionError(f"{label}: {fold.__name__} overflowed")
        tables.append(table)
    got, want = (compact_groups_plain(t).cpu().numpy() for t in tables)
    got, want = (t[:, np.argsort(t[0], kind="stable")] for t in (got, want))
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{label}: kernel 2's group table differs")
    err2 = float(np.max(np.abs(got - want), initial=0))
    del want
    scratch = spec.new_table(dev)
    pristine = scratch.clone()
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    ms2 = cuda_ms(lambda: hash_group_aggregate(spec, cols, aux, n, scratch,
                                               overflow), 5,
                  setup=lambda: scratch.copy_(pristine))
    plain2 = cuda_ms(lambda: hash_group_aggregate_plain(
        spec, cols, aux, n, scratch, overflow), 2,
        setup=lambda: scratch.copy_(pristine))
    del scratch, pristine, tables[1]
    groups, rows = got.shape[1], got.shape[0]
    # inputs read once, each live group's slot written once
    b2 = bound(col_bytes(cols, spec.pools.columns, n) + groups * rows * 8,
               prog_ops(spec, n))
    print(f"hash_group_aggregate {label}: {n} rows, {groups} groups, "
          f"{spec.cap} slots ({'identity' if spec.identity_slots else 'hashed'})"
          f": kernel {ms2:.6f} ms, plain {plain2:.6f} ms, bound "
          f"{b2['bound_ms']:.6f} ms, max_abs_err {err2} [{card}]", flush=True)
    table = tables[0]
    ms3 = cuda_ms(lambda: compact_groups(table), 10)
    plain3 = cuda_ms(lambda: compact_groups_plain(table), 3)
    # the key row read once, the rest of each live slot read once and
    # written once
    b3 = bound(spec.cap * 8 + groups * (2 * rows - 1) * 8, spec.cap)
    print(f"compact_groups {label}, no HAVING: {groups} of {spec.cap} "
          f"slots: kernel {ms3:.6f} ms, plain {plain3:.6f} ms, bound "
          f"{b3['bound_ms']:.6f} ms [{card}]", flush=True)
    k3 = None
    if having:
        hv = ex.having(spec, plan, names, slot_map)
        g3 = compact_groups(table, hv).cpu().numpy()
        w3 = compact_groups_plain(table, hv).cpu().numpy()
        if g3.shape != w3.shape or not np.array_equal(g3, w3):
            raise AssertionError(f"{label}: kernel 3's HAVING output differs")
        ms3 = cuda_ms(lambda: compact_groups(table, hv), 10)
        plain3 = cuda_ms(lambda: compact_groups_plain(table, hv), 3)
        # the key row read once, the rest of each live slot read once, the
        # kept groups written once
        b3 = bound(spec.cap * 8 + groups * (rows - 1) * 8 +
                   g3.shape[1] * rows * 8, groups * len(hv.prog.code))
        k3 = entry(0.0, ms3, plain3, b3)
        print(f"compact_groups {label} with HAVING: {g3.shape[1]} of "
              f"{groups} groups kept: kernel {ms3:.6f} ms, plain "
              f"{plain3:.6f} ms, bound {b3['bound_ms']:.6f} ms, max_abs_err "
              f"0.0 [{card}]", flush=True)
    return entry(err2, ms2, plain2, b2), k3, table, spec, names


def topk_vs_plain(table, lane, names, card, label):
    """`group_topk` against its plain version (the order column exactly,
    the key set beyond the k-th value), and `torch.topk` over the same row
    as the library yardstick. Returns the kernel's report entry."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        compact_groups_plain, group_topk, group_topk_plain)
    row = 2 + names.index(lane)
    got = compact_groups_plain(table, slots=group_topk(table, row, False, 10))
    want = compact_groups_plain(table,
                                slots=group_topk_plain(table, row, False, 10))
    g, w = got.cpu().numpy(), want.cpu().numpy()
    gv, wv = np.sort(g[row]), np.sort(w[row])
    kth = wv[0]
    if not np.array_equal(gv, wv) or not np.array_equal(
            np.sort(g[0][g[row] > kth]), np.sort(w[0][w[row] > kth])):
        raise AssertionError(f"{label}: kernel 4's top 10 differs")
    ms = cuda_ms(lambda: group_topk(table, row, False, 10), 10)
    plain = cuda_ms(lambda: group_topk_plain(table, row, False, 10), 3)
    lane_row = table[row]
    library = cuda_ms(lambda: torch.topk(lane_row, 10), 10)
    cap = table.shape[1]
    bnd = bound(cap * 8 * 2 + 10 * 8, cap)   # the key and lane rows once
    print(f"group_topk {label}: top 10 counts {wv[::-1].tolist()}: kernel "
          f"{ms:.6f} ms, plain {plain:.6f} ms, torch.topk {library:.6f} ms, "
          f"bound {bnd['bound_ms']:.6f} ms, max_abs_err 0.0 [{card}]",
          flush=True)
    return entry(0.0, ms, plain, bnd, library)


def chain_builds_vs_plain(ex, tctx, card, label):
    """`chain_build` against its plain version on every build side of the
    chain exec `ex` (the same kind, ranges, shifts, live rows and
    duplicate flag, the same keys, and for an INNER build the same row of
    each key). Returns the report entry of the largest build side."""
    import numpy as np
    from datafusion_tpu_torch.device.join_chain import (
        TAB_HASH, chain_build, chain_build_plain)
    best = None
    for h, bi in enumerate(ex.build_inputs(tctx)):
        n = bi.batch.num_rows
        got = chain_build(bi.spec, bi.cols, bi.aux, n, bi.unique)
        want = chain_build_plain(bi.spec, bi.cols, bi.aux, n, bi.unique)

        def shape(t):
            return (t.kind, t.los, t.his, t.shifts, t.size, t.live,
                    t.duplicate)
        gk, gr = got.entries()
        wk, wr = want.entries()
        # a SEMI or ANTI build stores presence: of a key's rows, either
        # version may keep any one
        if shape(got) != shape(want) or not np.array_equal(gk, wk) or \
                (bi.unique and not np.array_equal(gr, wr)):
            raise AssertionError(f"{label} build {h}: chain_build differs "
                                 f"from its plain version: {shape(got)} "
                                 f"{shape(want)}")
        ms = cuda_ms(lambda: chain_build(bi.spec, bi.cols, bi.aux, n,
                                         bi.unique), 5)
        plain = cuda_ms(lambda: chain_build_plain(bi.spec, bi.cols, bi.aux,
                                                  n, bi.unique), 2)
        # inputs read once, the table written once
        nbytes = col_bytes(bi.cols, bi.spec.pools.columns, n) + \
            got.size * (4 + 8 * (got.kind == TAB_HASH))
        bnd = bound(nbytes, prog_ops(bi.spec, n))
        kind = ["direct", "hashed", "empty"][got.kind]
        print(f"chain_build {label} build {h}: {n} rows, {got.live} live, "
              f"{kind} table of {got.size} slots: kernel {ms:.6f} ms, plain "
              f"{plain:.6f} ms, bound {bnd['bound_ms']:.6f} ms, max_abs_err "
              f"0 [{card}]", flush=True)
        if best is None or n > best[0]:
            best = (n, entry(0.0, ms, plain, bnd))
    return best[1]


def chain_walk_vs_plain(ex, tctx, card, label):
    """`chain_aggregate` against its plain version on the chain's staged
    builds and spine (equal group tables, compacted and ordered by key;
    every lane of Q3 and Q5 is an exact decimal sum or a count). The bound
    counts the spine columns read once, then for each hop a table read per
    row that reaches it and its payload read per row that survives it.
    Returns the kernel's report entry."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        AggregateSpec, compact_groups_plain, dense_group_table)
    from datafusion_tpu_torch.device.join_chain import (
        TAB_HASH, chain_aggregate, chain_aggregate_plain)
    spec, _plan, _names, _slots, inputs, staged = ex.prepare(tctx)
    ((cols, aux, n),) = inputs
    dev = aux.device
    dense = isinstance(spec, AggregateSpec)
    hop_rows = []
    tables = []
    for fold in (chain_aggregate, chain_aggregate_plain):
        table = spec.new_table(dev)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        kw = {"hop_rows": hop_rows} if fold is chain_aggregate_plain else {}
        fold(spec, cols, aux, n, table, overflow, **kw)
        torch.cuda.synchronize()
        if int(overflow.item()):
            raise AssertionError(f"{label}: {fold.__name__} overflowed")
        tables.append(dense_group_table(table) if dense else table)
    got, want = (compact_groups_plain(t).cpu().numpy() for t in tables)
    got, want = (t[:, np.argsort(t[0], kind="stable")] for t in (got, want))
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{label}: chain_aggregate's group table "
                             f"differs from its plain version")
    del tables
    scratch = spec.new_table(dev)
    pristine = scratch.clone()
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: chain_aggregate(spec, cols, aux, n, scratch,
                                         overflow), 5,
                 setup=lambda: scratch.copy_(pristine))
    plain = cuda_ms(lambda: chain_aggregate_plain(spec, cols, aux, n,
                                                  scratch, overflow), 2,
                    setup=lambda: scratch.copy_(pristine))
    del scratch, pristine
    hop_of = spec.chain.hop_of
    nbytes = col_bytes(cols, [i for i in spec.pools.columns
                              if i not in hop_of], n)
    for h, (hop, (reach, alive)) in enumerate(zip(spec.chain.hops,
                                                  hop_rows)):
        payload = [i for i in spec.pools.columns if hop_of.get(i) == h]
        nbytes += reach * (4 + 8 * (hop.table.kind == TAB_HASH)) + \
            col_bytes(cols, payload, alive)
    nbytes += got.shape[1] * got.shape[0] * 8    # live groups written once
    bnd = bound(nbytes, prog_ops(spec, n))
    print(f"chain_aggregate {label}: {n} spine rows, {len(spec.chain.hops)} "
          f"hops, rows reaching/surviving each hop {hop_rows}, "
          f"{'dense' if dense else 'hash'} fold, {got.shape[1]} groups: "
          f"kernel {ms:.6f} ms, plain {plain:.6f} ms, bound "
          f"{bnd['bound_ms']:.6f} ms ({bnd['bytes']} bytes), max_abs_err 0 "
          f"[{card}]", flush=True)
    return entry(0.0, ms, plain, bnd)


def sort_input(ctx, sql):
    """The query's SortExec, the rows it sorts (its input run alone on the
    host: the filter and projection), the host seconds that took, and its
    order words as the main path encodes them."""
    from datafusion_tpu_torch.physical.plan.base import collect_batch
    from datafusion_tpu_torch.physical.plan.sort import SortExec, order_keys
    ex = find_exec(ctx.sql(sql).create_physical_plan(), SortExec)
    t0 = time.perf_counter()
    batch = collect_batch(ex.input, ctx.task_context())
    secs = time.perf_counter() - t0
    words = [w for se in ex.sort_exprs
             for w in order_keys(se.expr.evaluate(batch), se.asc,
                                 se.nulls_first)]
    return ex, batch, secs, words


def radix_vs_plain(words, dev, card, label, library=False):
    """`radix_sort` against its plain version on the order words (equal
    permutations), both timed; with `library` a stable `torch.sort` of the
    first value word (as int64 order) as the yardstick. The bound counts
    each word read once and the permutation written once. Returns (the
    kernel's report entry, its permutation)."""
    import torch
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.physical.plan.device_sort import (
        radix_sort, radix_sort_plain, to_word)
    staged = [to_word(w).to(dev) for w in words]
    n = len(words[0])
    before = kernels.launch_counts()["radix_sort"]
    got = radix_sort(staged)
    launches = kernels.launch_counts()["radix_sort"] - before
    want = radix_sort_plain(staged)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: radix_sort differs from its plain "
                             f"version")
    del want
    ms = cuda_ms(lambda: radix_sort(staged), 5)
    plain = cuda_ms(lambda: radix_sort_plain(staged), 2)
    lib = None
    if library:
        key = staged[1] ^ (-2**63)
        lib = cuda_ms(lambda: torch.sort(key, stable=True), 5)
        del key
    bnd = bound(sum(n * w.dtype.itemsize for w in words) + n * 8,
                n * len(words))
    print(f"radix_sort {label}: {n} rows, {len(words)} words, {launches} "
          f"launches a sort: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
          f"torch.sort {lib} ms, bound {bnd['bound_ms']:.6f} ms, "
          f"max_abs_err 0 [{card}]", flush=True)
    return entry(0.0, ms, plain, bnd, lib), got.cpu().numpy()


def oracle_first(keys, k=10):
    """Row indices of the first k rows in the stable order of `keys` (most
    significant first): the candidates at or below the k-th smallest first
    key, ordered by np.lexsort."""
    import numpy as np
    kth = np.partition(keys[0], k - 1)[k - 1]
    cand = np.flatnonzero(keys[0] <= kth)
    return cand[np.lexsort(tuple(x[cand] for x in reversed(keys)))[:k]]


def window_kernels_vs_plain(ctx, sql, card, label):
    """For each window function of the query's WindowExec, on the inputs
    of one evaluation of the main path (a BoundedWindowExec's first
    partition run): `radix_sort`, `gather_lanes` and `window_scan` against
    their plain versions (equal, all of them: W1-W3 sum only decimals).
    Bounds: the gather reads the index once and each lane once and writes
    each lane once; the scan reads the sorted words, lanes and the
    permutation once and writes each output once. Returns the report
    entries (gather, scan) of the first function."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        reorder_rows, reorder_rows_plain)
    from datafusion_tpu_torch.device.window import (
        stage_window, window_scan, window_scan_plain)
    from datafusion_tpu_torch.physical.plan.base import collect_batch
    from datafusion_tpu_torch.physical.plan.device_sort import (
        radix_sort, radix_sort_plain)
    from datafusion_tpu_torch.physical.plan.window import (
        BoundedWindowExec, WindowExec, _plan_window_evaluation,
        device_window_inputs)
    ex = find_exec(ctx.sql(sql).create_physical_plan(), WindowExec)
    batch = collect_batch(ex.input, ctx.task_context())
    if isinstance(ex, BoundedWindowExec):
        key = ex.window_exprs[0].partition_by[0].evaluate(batch).data_host()
        cut = int(np.argmax(key != key[0])) or batch.num_rows
        batch = batch.take_host(np.arange(cut))
    n, first = batch.num_rows, None
    for w in _plan_window_evaluation(ex.window_exprs,
                                     ex.input.output_ordering()):
        inputs = device_window_inputs(w, batch)
        if inputs is None:
            raise AssertionError(f"{label}: {w.name} is outside the device "
                                 f"family")
        spec, pw, ow, lanes, _arg_col = inputs
        words, lanes = stage_window(pw, ow, n, spec, **lanes,
                                    device=ctx.device)
        perm = radix_sort(words)
        if not torch.equal(perm, radix_sort_plain(words)):
            raise AssertionError(f"{label} {spec}: radix_sort differs")
        extras = [x for x in lanes if x is not None]
        moved = reorder_rows(perm, words + extras)
        for g, p in zip(moved, reorder_rows_plain(perm, words + extras)):
            if not torch.equal(g, p):
                raise AssertionError(f"{label} {spec}: gather_lanes differs")
        sw, rest = moved[:len(words)], iter(moved[len(words):])
        sl = [None if x is None else next(rest) for x in lanes]
        got = window_scan(sw, len(pw), perm, spec, *sl)
        want = window_scan_plain(sw, len(pw), perm, spec, *sl)
        torch.cuda.synchronize()
        for k in want:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"{label} {spec}: window_scan's {k} "
                                     f"differs")
        del want
        ms_g = cuda_ms(lambda: reorder_rows(perm, words + extras), 5)
        plain_g = cuda_ms(lambda: reorder_rows_plain(perm, words + extras), 2)
        width = sum(t.element_size() for t in words + extras)
        b_g = bound(n * 8 + 2 * n * width, 0)
        ms_s = cuda_ms(lambda: window_scan(sw, len(pw), perm, spec, *sl), 5)
        plain_s = cuda_ms(
            lambda: window_scan_plain(sw, len(pw), perm, spec, *sl), 2)
        read = n * (8 + sum(t.element_size() for t in sw) +
                    sum(t.element_size() for t in sl if t is not None))
        wrote = sum(v.numel() * v.element_size() for v in got.values())
        b_s = bound(read + wrote, n)
        print(f"{label} {spec}: {n} rows, {len(words)} words, {len(extras)} "
              f"lanes; gather_lanes kernel {ms_g:.6f} ms, plain "
              f"{plain_g:.6f} ms, bound {b_g['bound_ms']:.6f} ms; "
              f"window_scan kernel {ms_s:.6f} ms, plain {plain_s:.6f} ms, "
              f"bound {b_s['bound_ms']:.6f} ms; every output equal "
              f"[{card}]", flush=True)
        if first is None:
            first = (entry(0.0, ms_g, plain_g, b_g),
                     entry(0.0, ms_s, plain_s, b_s))
        del words, lanes, extras, perm, moved, sw, sl, got
        torch.cuda.empty_cache()
    return first


# ---- numpy oracles of the window queries -------------------------------------

def oracle_w1(li):
    """W1's rows as columns: rank() by price descending in each supplier
    (one stable argsort of a packed key), each order's quantity sum
    (l_orderkey is sorted here), rows with rank <= 3."""
    import numpy as np
    supp, ok, price, qty = (col(li, c) for c in (
        "l_suppkey", "l_orderkey", "l_extendedprice", "l_quantity"))
    if price.max() >= 1 << 24 or supp.max() >= 1 << 38:
        raise AssertionError("W1's packed key does not fit")
    n = len(supp)
    key = (supp << 24) | ((1 << 24) - 1 - price)
    order = np.argsort(key, kind="stable")
    ks, ss = key[order], supp[order]
    idx = np.arange(n)
    first_val = np.maximum.accumulate(
        np.where(np.r_[True, ks[1:] != ks[:-1]], idx, 0))
    first_part = np.maximum.accumulate(
        np.where(np.r_[True, ss[1:] != ss[:-1]], idx, 0))
    rk = np.empty(n, np.int64)
    rk[order] = first_val - first_part + 1
    del key, order, ks, ss, idx, first_val, first_part
    starts = np.flatnonzero(np.r_[True, ok[1:] != ok[:-1]])
    order_qty = np.repeat(np.add.reduceat(qty, starts),
                          np.diff(np.r_[starts, n]))
    m = rk <= 3
    return [supp[m], ok[m], price[m], rk[m], order_qty[m]]


def same_rows(got, want):
    """Equal rows in any order: both sets of columns sorted by all
    columns."""
    import numpy as np
    og = np.lexsort(tuple(reversed(got)))
    ow = np.lexsort(tuple(reversed(want)))
    return all(np.array_equal(g[og], w[ow]) for g, w in zip(got, want))


def window_order(li, cols):
    """The stable order of lineitem by `cols`, nonnegative integers packed
    into one int64 key."""
    import numpy as np
    key, bits = np.zeros(li.num_rows, np.int64), 0
    for c in cols:
        v = col(li, c).astype(np.int64)
        width = max(int(v.max()).bit_length(), 1)
        bits += width
        if v.min() < 0 or bits > 63:
            raise AssertionError(f"{cols} do not fit one packed key")
        key = (key << width) | v
    return np.argsort(key, kind="stable")


# ---- numpy oracles of the join chains ---------------------------------------

def oracle_q3(t):
    """(l_orderkey, revenue at scale 4, o_orderdate) of Q3's top 10."""
    import numpy as np
    cust, orders, li = t["customer"], t["orders"], t["lineitem"]
    seg = cust.column_by_name("c_mktsegment")
    building = col(cust, "c_mktsegment") == seg.dictionary.lookup("BUILDING")
    o_date = col(orders, "o_orderdate")
    o_ok = (o_date < days(1995, 3, 15)) & \
        building[col(orders, "o_custkey") - 1]
    oi = (col(li, "l_orderkey") + 3) // 4 - 1
    m = o_ok[oi] & (col(li, "l_shipdate") > days(1995, 3, 15))
    oim = oi[m]
    rev = col(li, "l_extendedprice")[m] * (100 - col(li, "l_discount")[m])
    starts = np.flatnonzero(np.r_[True, oim[1:] != oim[:-1]])
    sums = np.add.reduceat(rev, starts)
    keys = oim[starts]
    top = np.lexsort((o_date[keys], -sums))[:10]
    return keys[top] * 4 + 1, sums[top], o_date[keys[top]], len(keys)


def oracle_q4(t):
    """Q4's order count of each priority, in priority order."""
    import numpy as np
    orders, li = t["orders"], t["lineitem"]
    late = col(li, "l_commitdate") < col(li, "l_receiptdate")
    has = np.zeros(orders.num_rows, bool)
    has[(col(li, "l_orderkey")[late] + 3) // 4 - 1] = True
    o_date = col(orders, "o_orderdate")
    m = (o_date >= days(1993, 7, 1)) & (o_date < days(1993, 10, 1)) & has
    prio = orders.column_by_name("o_orderpriority")
    counts = np.bincount(col(orders, "o_orderpriority")[m],
                         minlength=len(prio.dictionary))
    return list(prio.dictionary.values[counts > 0]), counts[counts > 0]


def oracle_q5(t):
    """Q5's (nation name, revenue at scale 4), by revenue descending."""
    import numpy as np
    cust, orders, li = t["customer"], t["orders"], t["lineitem"]
    nation, region, supp = t["nation"], t["region"], t["supplier"]
    asia = region.column_by_name("r_name").dictionary.lookup("ASIA")
    r_asia = col(region, "r_regionkey")[col(region, "r_name") == asia]
    n_in = np.isin(col(nation, "n_regionkey"), r_asia)
    o_date = col(orders, "o_orderdate")
    o_ok = (o_date >= days(1994, 1, 1)) & (o_date < days(1995, 1, 1))
    oi = (col(li, "l_orderkey") + 3) // 4 - 1
    s_nat = col(supp, "s_nationkey")[col(li, "l_suppkey") - 1]
    c_nat = col(cust, "c_nationkey")[col(orders, "o_custkey")[oi] - 1]
    m = o_ok[oi] & (c_nat == s_nat) & n_in[s_nat]
    rev = col(li, "l_extendedprice")[m] * (100 - col(li, "l_discount")[m])
    nat = s_nat[m]
    names = nation.column_by_name("n_name")
    out = [(names.dictionary.values[col(nation, "n_name")[k]],
            int(rev[nat == k].sum())) for k in np.flatnonzero(n_in)
           if (nat == k).any()]
    return sorted(out, key=lambda r: -r[1])


def main() -> int:
    for blocked in ("jax", "datafusion_tpu", "bench"):
        sys.modules[blocked] = None     # the port stands alone
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH

    card = smi()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {kernels.build_seconds} s)", flush=True)

    dev = torch.device(DEVICE)
    report = {}        # kernel -> its entry of the kernels line
    launched = {k: 0 for k in kernels.KERNELS}

    def add(counts):
        for k, v in counts.items():
            launched[k] += v

    # == dense path: Q1 and Q6 ===============================================
    t0 = time.perf_counter()
    sf10 = make_lineitem(SF10_ROWS, seed=0)
    print(f"lineitem SF10: {SF10_ROWS} rows made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    ctx = dft.SessionContext(dev)
    ctx.register_table("lineitem", dft.MemTable(sf10.schema, [[sf10]]))
    k1 = kernel_vs_plain(ctx, Q1, "lineitem", None)
    report["fused_dense_aggregate"] = k1
    print(f"fused_dense_aggregate Q1 SF10 lanes: kernel {k1['ms']:.6f} ms, "
          f"plain {k1['plain_ms']:.6f} ms, bound {k1['bound_ms']:.6f} ms, "
          f"max_abs_err {k1['max_abs_err']} [{card}]", flush=True)
    fctx = dft.SessionContext(dev)
    fb = float_batch(FLOAT_ROWS, seed=1)
    fctx.register_table("t", dft.MemTable(fb.schema, [[fb]]))
    kf = kernel_vs_plain(fctx, FLOAT_QUERY, "t", 1e-9)
    print(f"fused_dense_aggregate f64 lanes ({FLOAT_ROWS} rows, NULLs and "
          f"NaNs): kernel {kf['ms']:.6f} ms, plain {kf['plain_ms']:.6f} ms, "
          f"max_abs_err {kf['max_abs_err']} (sums within rel 1e-9) [{card}]",
          flush=True)
    del fctx, fb

    out, counts, _ = run_path(ctx, Q1, ["fused_dense_aggregate",
                                        "compact_groups"],
                              card, "Q1 SF10", SF10_ROWS)
    add(counts)
    ship = col(sf10, "l_shipdate")
    got_count = col(out, "count_order")
    if out.num_rows != 4 or int(got_count.sum()) != int(
            np.count_nonzero(ship <= days(1998, 9, 2))):
        raise AssertionError("Q1 SF10 disagrees with numpy")
    qty, price, disc, tax = (col(sf10, c) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    m = ship <= days(1998, 9, 2)
    g = (col(sf10, "l_returnflag") * 2 + col(sf10, "l_linestatus"))[m]
    charge = (price * (100 - disc) * (100 + tax))[m]
    got_g = col(out, "l_returnflag") * 2 + col(out, "l_linestatus")
    want_charge = [int(charge[g == k].sum()) for k in got_g]
    if col(out, "sum_charge").tolist() != want_charge:
        raise AssertionError("Q1 SF10 sum_charge disagrees with numpy")
    print(f"Q1 SF10 equals numpy: count_order {got_count.tolist()}, "
          f"sum_charge exactly (scale 6)", flush=True)

    q6 = kernel_vs_plain(ctx, Q6, "lineitem", None)
    print(f"fused_dense_aggregate Q6 SF10 (G = 1): kernel {q6['ms']:.6f} ms, "
          f"plain {q6['plain_ms']:.6f} ms, bound {q6['bound_ms']:.6f} ms, "
          f"max_abs_err {q6['max_abs_err']} [{card}]", flush=True)
    out, counts, _ = run_path(ctx, Q6, ["fused_dense_aggregate"], card,
                              "Q6 SF10", SF10_ROWS)
    add(counts)
    m = ((ship >= days(1994, 1, 1)) & (ship < days(1995, 1, 1)) &
         (disc / 100.0 >= 0.05) & (disc / 100.0 <= 0.07) & (qty < 2400))
    want_q6 = int((price[m] * disc[m]).sum())
    if int(out.columns[0].data_host()[0]) != want_q6:
        raise AssertionError(f"Q6 SF10: {out.columns[0].data_host()} != "
                             f"{want_q6}")
    print(f"Q6 SF10 revenue equals numpy exactly: {want_q6} (scale 4), "
          f"{int(m.sum())} rows pass", flush=True)
    del ctx, sf10, ship, qty, price, disc, tax, m, g, charge

    # == TPC-H SF10: hash path (Q18's and Q15's subqueries) ==================
    t0 = time.perf_counter()
    tables = tpch_tables(10, seed=0)
    li = tables["lineitem"]
    print(f"TPC-H SF10: " + ", ".join(
        f"{k} {v.num_rows}" for k, v in tables.items()) +
        f" rows made in {time.perf_counter() - t0:.3f} s", flush=True)
    ctx = dft.SessionContext(dev)
    for tname, b in tables.items():
        ctx.register_table(tname, dft.MemTable(b.schema, [[b]]))
    k2, k3, table, _s, _n = hash_kernel_vs_plain(ctx, Q18_SUB, "Q18 sub SF10",
                                                 card, having=True)
    del table
    report["hash_group_aggregate"] = k2
    report["compact_groups"] = k3
    _k2, _k3, table, _s, _n = hash_kernel_vs_plain(ctx, Q15_SUB,
                                                   "Q15 sub SF10", card)
    del table

    ok_, supp, qty, price, disc, ship = (col(li, c) for c in (
        "l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice",
        "l_discount", "l_shipdate"))
    out, counts, _ = run_path(ctx, Q18_SUB, ["hash_group_aggregate",
                                             "compact_groups"],
                              card, "Q18 sub SF10", li.num_rows)
    add(counts)
    starts = np.flatnonzero(np.r_[True, ok_[1:] != ok_[:-1]])
    sums = np.add.reduceat(qty, starts)
    want18 = ok_[starts][sums > 300 * 100]
    if not np.array_equal(np.sort(out.columns[0].data_host()), want18):
        raise AssertionError("Q18 sub SF10 disagrees with numpy")
    print(f"Q18 sub SF10 equals numpy exactly: {len(starts)} groups, "
          f"{len(want18)} survive the HAVING", flush=True)
    breakdown(ctx, Q18_SUB, card, "Q18 sub SF10")

    out, counts, _ = run_path(ctx, Q15_SUB, ["hash_group_aggregate",
                                             "compact_groups"],
                              card, "Q15 sub SF10", li.num_rows)
    add(counts)
    m = (ship >= days(1996, 1, 1)) & (ship < days(1996, 4, 1))
    rev = np.zeros(int(supp.max()) + 1, np.int64)
    np.add.at(rev, supp[m], price[m] * (100 - disc[m]))
    live = np.zeros(len(rev), bool)
    live[supp[m]] = True
    got_s, got_r = (c.data_host() for c in out.columns)
    o = np.argsort(got_s)
    if not (np.array_equal(got_s[o], np.flatnonzero(live)) and
            np.array_equal(got_r[o], rev[live])):
        raise AssertionError("Q15 sub SF10 disagrees with numpy")
    print(f"Q15 sub SF10 equals numpy exactly: {int(m.sum())} rows pass, "
          f"{out.num_rows} groups", flush=True)
    breakdown(ctx, Q15_SUB, card, "Q15 sub SF10")
    del ok_, supp, qty, price, disc, ship, m, rev, live, starts, sums

    # == TPC-H SF10: join chains (Q3, Q4, Q5) =================================
    chain = ["chain_build", "chain_aggregate"]
    tctx = ctx.task_context()
    for q in (5, 3, 4):
        ex = find_exec(ctx.sql(TPCH[q]).create_physical_plan(),
                       TorchJoinChainAggregateExec)
        if ex is None:
            raise AssertionError(f"Q{q} plans no TorchJoinChainAggregateExec")
        print(f"Q{q} SF10 plans {ex.display_line()}", flush=True)
        kb = chain_builds_vs_plain(ex, tctx, card, f"Q{q} SF10")
        kw = chain_walk_vs_plain(ex, tctx, card, f"Q{q} SF10")
        if q == 5:
            report["chain_build"], report["chain_aggregate"] = kb, kw
    torch.cuda.empty_cache()

    out, counts, _ = run_path(ctx, TPCH[3], chain + ["compact_groups"], card,
                              "Q3 SF10", li.num_rows,
                              TorchJoinChainAggregateExec)
    add(counts)
    keys, revs, dates, n_groups = oracle_q3(tables)
    if not (np.array_equal(col(out, "l_orderkey"), keys) and
            np.array_equal(col(out, "revenue"), revs) and
            np.array_equal(col(out, "o_orderdate"), dates) and
            not col(out, "o_shippriority").any()):
        raise AssertionError(f"Q3 SF10 disagrees with numpy:\n"
                             f"{out.to_pydict()}\n{keys} {revs} {dates}")
    print(f"Q3 SF10 equals numpy exactly: {n_groups} groups, top revenue "
          f"{revs[:3].tolist()} (scale 4)", flush=True)
    breakdown(ctx, TPCH[3], card, "Q3 SF10", TorchJoinChainAggregateExec)

    out, counts, _ = run_path(ctx, TPCH[4], chain + ["compact_groups"],
                              card, "Q4 SF10", tables["orders"].num_rows,
                              TorchJoinChainAggregateExec)
    add(counts)
    prios, want4 = oracle_q4(tables)
    got4 = out.to_pydict()
    if got4 != {"o_orderpriority": prios, "order_count": want4.tolist()}:
        raise AssertionError(f"Q4 SF10 disagrees with numpy: {got4} "
                             f"{prios} {want4}")
    print(f"Q4 SF10 equals numpy exactly: {want4.tolist()}", flush=True)
    breakdown(ctx, TPCH[4], card, "Q4 SF10", TorchJoinChainAggregateExec)

    out, counts, _ = run_path(ctx, TPCH[5], chain + ["compact_groups"],
                              card, "Q5 SF10",
                              li.num_rows, TorchJoinChainAggregateExec)
    add(counts)
    want5 = oracle_q5(tables)
    got5 = list(zip(out.columns[0].to_pylist(),
                    col(out, "revenue").tolist()))
    if got5 != want5:
        raise AssertionError(f"Q5 SF10 disagrees with numpy: {got5} {want5}")
    print(f"Q5 SF10 equals numpy exactly: {got5}", flush=True)
    breakdown(ctx, TPCH[5], card, "Q5 SF10", TorchJoinChainAggregateExec)
    del tctx, ex, out
    torch.cuda.empty_cache()

    # == TPC-H SF10: window functions (W1, W2, W3) ============================
    from datafusion_tpu_torch.physical.plan.window import WindowExec
    window = ["radix_sort", "gather_lanes", "window_scan"]
    n_li = li.num_rows
    for label, sql in (("W1", W1), ("W2", W2), ("W3", W3)):
        kg, ks = window_kernels_vs_plain(ctx, sql, card, f"{label} SF10")
        if label == "W1":
            report["gather_lanes"], report["window_scan"] = kg, ks

    out, counts, _ = run_path(ctx, W1, window, card, "W1 SF10", n_li,
                              WindowExec, reps=WINDOW_REPS)
    add(counts)
    want = oracle_w1(li)
    got = [col(out, c).astype(np.int64) for c in (
        "l_suppkey", "l_orderkey", "l_extendedprice", "rk", "order_qty")]
    if not same_rows(got, want):
        raise AssertionError("W1 SF10 disagrees with numpy")
    print(f"W1 SF10 equals numpy exactly: {out.num_rows} rows of rank <= 3 "
          f"over {len(np.unique(want[0]))} suppliers", flush=True)
    breakdown(ctx, W1, card, "W1 SF10", WindowExec, main="eval_kernel",
              host="none (no filter below the window)")
    del out, got, want

    out, counts, _ = run_path(ctx, W2, window, card, "W2 SF10", n_li,
                              WindowExec, reps=WINDOW_REPS)
    add(counts)
    order = window_order(li, ["l_shipdate", "l_orderkey"])
    price = col(li, "l_extendedprice")[order]
    prev = out.column_by_name("prev_price")
    if not (np.array_equal(col(out, "rn"), np.arange(1, n_li + 1)) and
            np.array_equal(col(out, "l_orderkey"),
                           col(li, "l_orderkey")[order]) and
            np.array_equal(col(out, "l_shipdate"),
                           col(li, "l_shipdate")[order]) and
            np.array_equal(col(out, "l_extendedprice"), price) and
            np.array_equal(prev.data_host()[1:], price[:-1]) and
            np.array_equal(prev.validity_host(), np.arange(n_li) > 0)):
        raise AssertionError("W2 SF10 disagrees with numpy")
    print(f"W2 SF10 equals numpy exactly: {n_li} rows, row_number and lag "
          f"in (l_shipdate, l_orderkey) order", flush=True)
    breakdown(ctx, W2, card, "W2 SF10", WindowExec, main="eval_kernel",
              host="none (no filter below the window)")
    del out, order, price, prev

    out, counts, _ = run_path(ctx, W3, window, card, "W3 SF10", n_li,
                              WindowExec, reps=WINDOW_REPS)
    add(counts)
    order = window_order(li, ["l_returnflag", "l_shipdate", "l_orderkey"])
    flag = col(li, "l_returnflag")[order]
    sums = np.cumsum(col(li, "l_quantity")[order])
    idx = np.arange(n_li)
    lo = np.maximum(idx - 6, np.maximum.accumulate(
        np.where(np.r_[True, flag[1:] != flag[:-1]], idx, 0)))
    qty7 = sums - np.where(lo >= 1, sums[np.maximum(lo - 1, 0)], 0)
    if not (np.array_equal(col(out, "l_returnflag"), flag) and
            np.array_equal(col(out, "l_shipdate"),
                           col(li, "l_shipdate")[order]) and
            np.array_equal(col(out, "l_orderkey"),
                           col(li, "l_orderkey")[order]) and
            np.array_equal(col(out, "qty7"), qty7)):
        raise AssertionError("W3 SF10 disagrees with numpy")
    print(f"W3 SF10 equals numpy exactly: {n_li} rows in "
          f"{len(np.unique(flag))} partition runs", flush=True)
    breakdown(ctx, W3, card, "W3 SF10", WindowExec, main="eval_kernel",
              host="none (no filter below the window)")
    del ctx, tables, li, out, order, flag, sums, idx, lo, qty7
    torch.cuda.empty_cache()

    # == hash path: ClickBench Q16 and Q17 at 99,997,497 rows ================
    t0 = time.perf_counter()
    hb = hits(HITS_ROWS, seed=0)
    print(f"hits: {HITS_ROWS} rows of UserID, SearchPhrase made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    ctx = dft.SessionContext(dev)
    ctx.register_table("hits", dft.MemTable(hb.schema, [[hb]]))
    _k2, _k3, table, _spec, names = hash_kernel_vs_plain(
        ctx, CB_Q16.split(" ORDER BY")[0], "CB Q16 SF100M", card)
    report["group_topk"] = topk_vs_plain(table, names[0], names, card,
                                         "CB Q16")
    del table
    _k2, _k3, table, _spec, names = hash_kernel_vs_plain(
        ctx, CB_Q17.split(" ORDER BY")[0], "CB Q17 SF100M", card)
    topk_vs_plain(table, names[0], names, card, "CB Q17")
    del table

    user = col(hb, "UserID")
    code = col(hb, "SearchPhrase")
    n_dic = len(hb.column_by_name("SearchPhrase").dictionary)
    out, counts, _ = run_path(ctx, CB_Q16, ["hash_group_aggregate",
                                            "group_topk", "compact_groups"],
                              card, "CB Q16", HITS_ROWS)
    add(counts)
    per_user = np.bincount(user)
    top_counts_agree("CB Q16", out.columns[0].data_host(),
                     out.columns[1].data_host(),
                     np.arange(len(per_user)), per_user)
    print(f"CB Q16 equals numpy: top counts "
          f"{out.columns[1].data_host().tolist()}, "
          f"{int(np.count_nonzero(per_user))} users", flush=True)
    breakdown(ctx, CB_Q16, card, "CB Q16")

    out, counts, _ = run_path(ctx, CB_Q17, ["hash_group_aggregate",
                                            "group_topk", "compact_groups"],
                              card, "CB Q17", HITS_ROWS)
    add(counts)
    pair, pair_n = np.unique(user * n_dic + code, return_counts=True)
    got_pair = (out.columns[0].data_host() * n_dic +
                out.columns[1].data_host())
    top_counts_agree("CB Q17", got_pair, out.columns[2].data_host(), pair,
                     pair_n)
    print(f"CB Q17 equals numpy: top counts "
          f"{out.columns[2].data_host().tolist()}, {len(pair)} groups",
          flush=True)
    breakdown(ctx, CB_Q17, card, "CB Q17")
    del pair, pair_n, per_user

    # == sort: ClickBench Q25, Q26 and Q27 ====================================
    from datafusion_tpu_torch.physical.plan.sort import SortExec
    event = col(hb, "EventTime")
    rows = np.flatnonzero(code != hb.column_by_name(
        "SearchPhrase").dictionary.lookup(""))
    phrases = hb.column_by_name("SearchPhrase").dictionary.values
    oracle_keys = {25: [event[rows]], 26: [code[rows]],
                   27: [event[rows], code[rows]]}
    host_ms = {}
    for q in (25, 26, 27):
        ex, batch, secs, words = sort_input(ctx, CB_SORTS[q])
        host_ms[q] = secs * 1e3
        print(f"CB Q{q} plans {ex.display_line()} over {batch.num_rows} "
              f"rows; its input (host filter and projection) took "
              f"{host_ms[q]:.3f} ms on its own", flush=True)
        kr, perm = radix_vs_plain(words, dev, card, f"CB Q{q}",
                                  library=q == 25)
        first = rows[oracle_first(oracle_keys[q])]
        if not np.array_equal(rows[perm[:10]], first):
            raise AssertionError(f"CB Q{q}: the sort's first rows differ "
                                 f"from numpy's")
        if q == 25:
            report["radix_sort"] = kr
        del batch, words, perm
    for q in (25, 26, 27):
        out, counts, _ = run_path(ctx, CB_SORTS[q], ["radix_sort"], card,
                                  f"CB Q{q}", HITS_ROWS, SortExec)
        add(counts)
        want = phrases[code[rows[oracle_first(oracle_keys[q])]]].tolist()
        if out.columns[0].to_pylist() != want:
            raise AssertionError(f"CB Q{q} disagrees with numpy: "
                                 f"{out.columns[0].to_pylist()} {want}")
        print(f"CB Q{q} equals numpy exactly: {want[:3]}... of "
              f"{len(rows)} rows with a search phrase", flush=True)
        breakdown(ctx, CB_SORTS[q], card, f"CB Q{q}", SortExec,
                  main="scatter_kernel",
                  host=f"filter and projection {host_ms[q]:.3f} ms run alone")
    del ctx, hb, user, code, event, rows, oracle_keys

    loaded = [m for m, v in sys.modules.items()
              if m.split(".")[0] in ("jax", "datafusion_tpu", "bench")
              and v is not None]
    if loaded:
        raise AssertionError(f"imported: {loaded}")
    print(f"smoke run: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [dict(
        name=k.name, route="cuda", source=k.source, replaces=k.replaces,
        launches=launched[k.name], **report[k.name])
        for k in kernels.KERNELS.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def top_counts_agree(label, got_keys, got_counts, all_keys, all_counts):
    """A top-10 result against the full group counts: the counts exactly,
    the keys exactly for counts beyond the 10th."""
    import numpy as np
    want = np.sort(all_counts)[::-1][:10]
    if list(got_counts) != want.tolist():
        raise AssertionError(f"{label}: counts {list(got_counts)} != "
                             f"{want.tolist()}")
    kth = want[-1]
    beyond = {k for k, c in zip(got_keys, got_counts) if c > kth}
    if beyond != set(np.asarray(all_keys)[all_counts > kth].tolist()):
        raise AssertionError(f"{label}: groups beyond the 10th count differ")


if __name__ == "__main__":
    sys.exit(main())
