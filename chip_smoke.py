#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through
`datafusion_tpu_torch.SessionContext(torch.device("cuda"))`:

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from `datafusion_tpu_torch/csrc` (one nvcc per
   source, all at once) and prints the build seconds;
3. dense path, TPC-H Q1 over `bench.make_lineitem` at SF10 (60,012,150
   rows): `fused_dense_aggregate` against its plain PyTorch version
   (int64 lanes exactly; float64 lanes with NULLs and NaNs, sums within
   rel 1e-9), Q1 end to end (warm median of 5), Q1 at SF1 against the
   JAX package's host path, and TPC-H Q6 (G = 1) end to end against a
   numpy oracle;
4. hash path over a TPC-H-shaped lineitem at SF10 (15,000,000 orders,
   about 60.0M rows, made here from a seed): `hash_group_aggregate`
   against its plain version on Q18's and Q15's subqueries (equal group
   tables), `compact_groups` with Q18's HAVING against its plain version
   (equal), then both subqueries end to end against numpy oracles, and at
   SF1 against the host path;
5. ClickBench's `UserID` and `SearchPhrase` at 99,997,497 rows (the
   public `hits` row count), drawn as `generate_hits` draws them:
   `group_topk` against its plain version on Q16, `hash_group_aggregate`
   against its plain version on Q17 (42-bit keys: the probing table), Q16
   and Q17 end to end against numpy oracles, and at 10,000,000 rows
   against the host path.

Each end-to-end path sets the launch counts to 0 just before it and reads
them just after; it fails if a kernel of the path was not launched or the
exec fell back to the host. Any failure raises and exits non-zero. JAX is
never imported. The last line is `{"ok": true, "device": {...}}`; the
line before it is the card's name and power limit, and before that one
JSON line lists every kernel.
"""
import datetime
import json
import os
import statistics
import subprocess
import sys
import time

SF1_ROWS = 6_001_215
SF10_ROWS = 60_012_150       # TPC-H SF10 lineitem, DataFusion's `bench.sh tpch10`
FLOAT_ROWS = 10_000_000
FLOAT_QUERY = ("SELECT g, count(*) c, sum(v) s, avg(v) a, min(v) mn, "
               "max(v) mx FROM t GROUP BY g")
ORDERS_PER_SF = 1_500_000    # TPC-H: 15,000,000 orders at SF10
HITS_ROWS = 99_997_497       # the public ClickBench hits.parquet
HITS_PARITY_ROWS = 10_000_000
REPS = 5
DEVICE = "cuda"

# TPC-H Q6 (tpch/queries.py), Q18's subquery and Q15's revenue0 body
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


def kernel_vs_plain(ctx, sql, table_name, float_rel):
    """Kernel and plain version of the query's dense aggregate on the same
    staged inputs. Returns (max_abs_err, kernel ms, plain ms)."""
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
    return err, ms, plain_ms


def float_batch(n: int, seed: int):
    import numpy as np
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column, Dictionary
    from datafusion_tpu.common.schema import Field, Schema
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 8, n).astype(np.int32)
    v = rng.normal(size=n) * 100
    v[rng.random(n) < 0.01] = np.nan
    valid = rng.random(n) >= 0.01
    schema = Schema([Field("g", dt.STRING, False),
                     Field("v", dt.FLOAT64, True)])
    dic = Dictionary(np.array(list("abcdefgh"), dtype=object))
    return Batch(schema, [Column(dt.STRING, g, None, dic),
                          Column(dt.FLOAT64, v, valid)], n)


def tpch_lineitem(sf: int, seed: int):
    """The lineitem columns of Q15 and Q18 by the rules of
    `datafusion_tpu/tpch/datagen.py:186-219`, vectorised: `l_orderkey` is
    4i - 3 repeated 1-7 times (so sorted), `l_suppkey` one of the 4
    suppliers of a uniform part, Decimal(15,2) quantity, price and
    discount, Date32 ship dates."""
    import numpy as np
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column
    from datafusion_tpu.common.schema import Field, Schema
    rng = np.random.default_rng(seed)
    n_orders = ORDERS_PER_SF * sf
    n_part, n_supp, per_part = 200_000 * sf, 10_000 * sf, 4
    ok = np.arange(1, n_orders + 1, dtype=np.int64) * 4 - 3
    o_date = rng.integers(days(1992, 1, 1), days(1998, 8, 2) - 151, n_orders)
    n_lines = rng.integers(1, 8, n_orders)
    l_order = np.repeat(ok, n_lines)
    n = len(l_order)
    part = rng.integers(1, n_part + 1, n).astype(np.int64)
    which = rng.integers(0, per_part, n)
    supp = ((part - 1 + which * (n_supp // per_part + 1)) % n_supp) + 1
    qty = rng.integers(1, 51, n).astype(np.int64)
    price = np.rint(qty * (90000 + (part % 20001) / 10 +
                           100 * (part % 1000))).astype(np.int64)
    disc = rng.integers(0, 11, n).astype(np.int64)
    ship = (np.repeat(o_date, n_lines) + rng.integers(1, 122, n)
            ).astype(np.int32)
    dec2 = dt.decimal(15, 2)
    schema = Schema([Field("l_orderkey", dt.INT64, False),
                     Field("l_suppkey", dt.INT64, False),
                     Field("l_quantity", dec2, False),
                     Field("l_extendedprice", dec2, False),
                     Field("l_discount", dec2, False),
                     Field("l_shipdate", dt.DATE, False)])
    return Batch(schema, [Column(dt.INT64, l_order), Column(dt.INT64, supp),
                          Column(dec2, qty * 100), Column(dec2, price),
                          Column(dec2, disc), Column(dt.DATE, ship)], n)


def hits(n: int, seed: int = 0):
    """`UserID` and `SearchPhrase` as `generate_hits` draws them (its first
    three draws: zipf(1.3), random, zipf(1.5); `clickbench/workload.py:
    15-26`), with the dictionary sorted as `register_hits` sorts it."""
    import numpy as np
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column, Dictionary
    from datafusion_tpu.common.schema import Field, Schema
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
    order = np.argsort(phrases.astype(str), kind="stable")
    rank = np.empty(len(order), np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    schema = Schema([Field("UserID", dt.INT64, False),
                     Field("SearchPhrase", dt.STRING, False)])
    return Batch(schema, [Column(dt.INT64, user),
                          Column(dt.STRING, rank[idx], None,
                                 Dictionary(phrases[order]))], n)


def run_path(ctx, sql, expect, card, label, rows):
    """The main path: launch counts set to 0, a warm-up and REPS timed
    runs, counts read. Fails unless every kernel of `expect` launched and
    the exec did not fall back. Returns (result batch, launches, ms)."""
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    kernels.reset_launch_counts()
    out = ctx.sql(sql).collect_batch()                # warm-up
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = ctx.sql(sql).collect_batch()
        times.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    ex = find_exec(ctx.sql(sql).create_physical_plan(),
                   TorchGroupAggregateExec)
    if ex is None or ex.fallbacks != 0:
        raise AssertionError(f"{label} fell back to the host aggregate")
    missing = [k for k in expect if launches[k] < 1]
    if missing:
        raise AssertionError(f"{label} did not launch {missing}")
    med = statistics.median(times) * 1e3
    print(f"{label} end to end: warm median of {REPS} {med:.3f} ms, "
          f"{rows / (med / 1e3):.1f} rows/s, launches "
          f"{ {k: launches[k] for k in expect} }, fallbacks {ex.fallbacks} "
          f"[{card}]", flush=True)
    return out, launches, med


def breakdown(ctx, sql, card, label):
    """Where one warm run's time goes: the host scan of the key columns'
    bounds (host clock), and per span of the exec (`dft.*`, host time,
    which waits for the card where a span reads a result back) and per
    kernel (device time) from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    ex = find_exec(ctx.sql(sql).create_physical_plan(),
                   TorchGroupAggregateExec)
    batches = ex.input_batches(ctx.task_context())
    t0 = time.perf_counter()
    for e, _n in ex.group_exprs:
        ex._phys_int_bounds(e, batches)
    bounds = (time.perf_counter() - t0) * 1e3
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
    # a trace that lost the aggregate kernel's event cannot give the share
    whole = any(k.endswith("aggregate_kernel") for k in device)
    print(f"{label} breakdown (one warm run, {wall:.3f} ms wall): key-bounds "
          f"scan {bounds:.3f} ms host; spans ms {spans}; device ms {device}; "
          f"device busy {busy:.3f} ms, idle share "
          f"{(1 - busy / wall) if whole else 'not measured'} [{card}]",
          flush=True)


def hash_kernel_vs_plain(ctx, sql, label, card, having=False):
    """`hash_group_aggregate` against its plain version on the query's
    staged inputs (equal group tables, ordered by key), and with `having`
    `compact_groups` with the query's HAVING against its plain version
    (equal, column for column). Returns ((max_abs_err, ms, plain_ms) of
    kernel 2, the same of kernel 3 or None, the kernel's table, spec,
    lane names)."""
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
    print(f"hash_group_aggregate {label}: {n} rows, {got.shape[1]} groups, "
          f"{spec.cap} slots ({'identity' if spec.identity_slots else 'hashed'})"
          f": kernel {ms2:.6f} ms, plain {plain2:.6f} ms, max_abs_err "
          f"{err2} [{card}]", flush=True)
    table = tables[0]
    ms3 = cuda_ms(lambda: compact_groups(table), 10)
    plain3 = cuda_ms(lambda: compact_groups_plain(table), 3)
    print(f"compact_groups {label}, no HAVING: {got.shape[1]} of {spec.cap} "
          f"slots: kernel {ms3:.6f} ms, plain {plain3:.6f} ms [{card}]",
          flush=True)
    k3 = None
    if having:
        hv = ex.having(spec, plan, names, slot_map)
        g3 = compact_groups(table, hv).cpu().numpy()
        w3 = compact_groups_plain(table, hv).cpu().numpy()
        if g3.shape != w3.shape or not np.array_equal(g3, w3):
            raise AssertionError(f"{label}: kernel 3's HAVING output differs")
        ms3 = cuda_ms(lambda: compact_groups(table, hv), 10)
        plain3 = cuda_ms(lambda: compact_groups_plain(table, hv), 3)
        k3 = (0.0, ms3, plain3)
        print(f"compact_groups {label} with HAVING: {g3.shape[1]} of "
              f"{got.shape[1]} groups kept: kernel {ms3:.6f} ms, plain "
              f"{plain3:.6f} ms, max_abs_err 0.0 [{card}]", flush=True)
    return (err2, ms2, plain2), k3, tables[0], spec, names


def topk_vs_plain(table, spec, names, lane, card, label):
    """`group_topk` against its plain version (the order column exactly,
    the key set beyond the k-th value). Returns (0.0, ms, plain_ms)."""
    import numpy as np
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
    print(f"group_topk {label}: top 10 counts {wv[::-1].tolist()}: kernel "
          f"{ms:.6f} ms, plain {plain:.6f} ms, max_abs_err 0.0 [{card}]",
          flush=True)
    return 0.0, ms, plain


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


def same_top(label, got, want, key_cols, count_col):
    """Two top-10 results: the counts exactly, the keys beyond the 10th."""
    if got[count_col] != want[count_col]:
        raise AssertionError(f"{label}: {got[count_col]} != {want[count_col]}")
    kth = want[count_col][-1]

    def beyond(r):
        return {tuple(r[c][i] for c in key_cols)
                for i, n in enumerate(r[count_col]) if n > kth}
    if beyond(got) != beyond(want):
        raise AssertionError(f"{label}: groups beyond the 10th count differ")


def main() -> int:
    sys.modules["jax"] = None   # the port must run without JAX
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import bench
    import datafusion_tpu as ref
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch import kernels

    card = smi()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    kernels.library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {kernels.build_seconds} s)", flush=True)

    dev = torch.device(DEVICE)
    report = {}        # kernel -> (max_abs_err, ms, plain_ms)
    launched = {k: 0 for k in kernels.KERNELS}

    def add(counts):
        for k, v in counts.items():
            launched[k] += v

    # == dense path: Q1 and Q6 ===============================================
    t0 = time.perf_counter()
    sf10 = bench.make_lineitem(SF10_ROWS, seed=0)
    print(f"lineitem SF10: {SF10_ROWS} rows made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    ctx = dft.SessionContext(dev)
    ctx.register_table("lineitem", dft.MemTable(sf10.schema, [[sf10]]))
    err, ms, plain_ms = kernel_vs_plain(ctx, bench.Q1, "lineitem", None)
    report["fused_dense_aggregate"] = (err, ms, plain_ms)
    print(f"fused_dense_aggregate Q1 SF10 lanes: kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, max_abs_err {err} [{card}]", flush=True)
    fctx = dft.SessionContext(dev)
    fb = float_batch(FLOAT_ROWS, seed=1)
    fctx.register_table("t", dft.MemTable(fb.schema, [[fb]]))
    ferr, fms, fplain = kernel_vs_plain(fctx, FLOAT_QUERY, "t", 1e-9)
    print(f"fused_dense_aggregate f64 lanes ({FLOAT_ROWS} rows, NULLs and "
          f"NaNs): kernel {fms:.6f} ms, plain {fplain:.6f} ms, "
          f"max_abs_err {ferr} (sums within rel 1e-9) [{card}]", flush=True)
    del fctx, fb

    out, counts, _ = run_path(ctx, bench.Q1, ["fused_dense_aggregate",
                                              "compact_groups"],
                              card, "Q1 SF10", SF10_ROWS)
    add(counts)
    ship = sf10.columns[6].data_host()
    got_count = out.columns[9].data_host()
    if out.num_rows != 4 or int(got_count.sum()) != int(
            np.count_nonzero(ship <= days(1998, 9, 2))):
        raise AssertionError("Q1 SF10 disagrees with numpy")

    qerr, qms, qplain = kernel_vs_plain(ctx, Q6, "lineitem", None)
    print(f"fused_dense_aggregate Q6 SF10 (G = 1): kernel {qms:.6f} ms, "
          f"plain {qplain:.6f} ms, max_abs_err {qerr} [{card}]", flush=True)
    out, counts, _ = run_path(ctx, Q6, ["fused_dense_aggregate"], card,
                              "Q6 SF10", SF10_ROWS)
    add(counts)
    qty, price, disc = (sf10.columns[i].data_host() for i in range(3))
    m = ((ship >= days(1994, 1, 1)) & (ship < days(1995, 1, 1)) &
         (disc / 100.0 >= 0.05) & (disc / 100.0 <= 0.07) & (qty < 2400))
    want_q6 = int((price[m] * disc[m]).sum())
    if int(out.columns[0].data_host()[0]) != want_q6:
        raise AssertionError(f"Q6 SF10: {out.columns[0].data_host()} != "
                             f"{want_q6}")
    print(f"Q6 SF10 revenue equals numpy exactly: {want_q6} (scale 4), "
          f"{int(m.sum())} rows pass", flush=True)
    del ctx, sf10, ship, qty, price, disc, m

    sf1 = bench.make_lineitem(SF1_ROWS, seed=0)
    port = dft.SessionContext(dev)
    port.register_table("lineitem", dft.MemTable(sf1.schema, [[sf1]]))
    host = ref.SessionContext()
    host.config.set("datafusion.tpu.device_aggregate", False)
    host.register_table("lineitem", ref.MemTable(sf1.schema, [[sf1]]))
    got, want = port.sql(bench.Q1).to_pydict(), host.sql(bench.Q1).to_pydict()
    if got != want:
        raise AssertionError(f"Q1 SF1 differs from the host path:\n{got}\n"
                             f"{want}")
    print(f"Q1 SF1 matches the host reference exactly: {len(got['l_returnflag'])}"
          f" rows, count_order {got['count_order']}", flush=True)
    del port, host, sf1

    # == hash path: TPC-H Q18's and Q15's subqueries at SF10 =================
    t0 = time.perf_counter()
    li = tpch_lineitem(10, seed=0)
    print(f"TPC-H-shaped lineitem SF10: {li.num_rows} rows made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    ctx = dft.SessionContext(dev)
    ctx.register_table("lineitem", dft.MemTable(li.schema, [[li]]))
    k2, k3, _t, _s, _n = hash_kernel_vs_plain(ctx, Q18_SUB, "Q18 sub SF10",
                                              card, having=True)
    del _t
    report["hash_group_aggregate"] = k2
    report["compact_groups"] = k3
    hash_kernel_vs_plain(ctx, Q15_SUB, "Q15 sub SF10", card)

    ok_, supp, qty, price, disc, ship = (c.data_host() for c in li.columns)
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
    del ctx, li, ok_, supp, qty, price, disc, ship, m

    small = tpch_lineitem(1, seed=1)
    port = dft.SessionContext(dev)
    port.register_table("lineitem", dft.MemTable(small.schema, [[small]]))
    host = ref.SessionContext()
    host.config.set("datafusion.tpu.device_aggregate", False)
    host.register_table("lineitem", ref.MemTable(small.schema, [[small]]))
    for label, sql, key in (("Q18 sub", Q18_SUB, "l_orderkey"),
                            ("Q15 sub", Q15_SUB, "supplier_no")):
        got, want = (c.sql(f"select * from ({sql}) order by {key}")
                     .to_pydict() for c in (port, host))
        if got != want:
            raise AssertionError(f"{label} SF1 differs from the host path")
        print(f"{label} SF1 ({small.num_rows} rows) matches the host "
              f"reference exactly: {len(got[key])} rows", flush=True)
    del port, host, small

    # == hash path: ClickBench Q16 and Q17 at 99,997,497 rows ================
    t0 = time.perf_counter()
    hb = hits(HITS_ROWS, seed=0)
    print(f"hits: {HITS_ROWS} rows of UserID, SearchPhrase made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    ctx = dft.SessionContext(dev)
    ctx.register_table("hits", dft.MemTable(hb.schema, [[hb]]))
    _k2, _k3, table, spec, names = hash_kernel_vs_plain(
        ctx, CB_Q16.split(" ORDER BY")[0], "CB Q16 SF100M", card)
    report["group_topk"] = topk_vs_plain(table, spec, names, names[0], card,
                                         "CB Q16")
    del table
    _k2, _k3, table, spec, names = hash_kernel_vs_plain(
        ctx, CB_Q17.split(" ORDER BY")[0], "CB Q17 SF100M", card)
    topk_vs_plain(table, spec, names, names[0], card, "CB Q17")
    del table

    user = hb.columns[0].data_host()
    code = hb.columns[1].data_host()
    dic = hb.columns[1].dictionary.values
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
    pair, pair_n = np.unique(user * len(dic) + code, return_counts=True)
    got_pair = (out.columns[0].data_host() * len(dic) +
                out.columns[1].data_host())
    top_counts_agree("CB Q17", got_pair, out.columns[2].data_host(), pair,
                     pair_n)
    print(f"CB Q17 equals numpy: top counts "
          f"{out.columns[2].data_host().tolist()}, {len(pair)} groups",
          flush=True)
    breakdown(ctx, CB_Q17, card, "CB Q17")
    del ctx, hb, user, code, pair, pair_n, per_user

    hp = hits(HITS_PARITY_ROWS, seed=0)
    port = dft.SessionContext(dev)
    port.register_table("hits", dft.MemTable(hp.schema, [[hp]]))
    host = ref.SessionContext()
    host.config.set("datafusion.tpu.device_aggregate", False)
    host.register_table("hits", ref.MemTable(hp.schema, [[hp]]))
    for label, sql, keys_, cnt in (
            ("CB Q16", CB_Q16, ["UserID"], "count(*)"),
            ("CB Q17", CB_Q17, ["UserID", "SearchPhrase"], "count(*)")):
        got, want = (c.sql(sql).to_pydict() for c in (port, host))
        same_top(f"{label} at {HITS_PARITY_ROWS} rows", got, want, keys_, cnt)
        print(f"{label} at {HITS_PARITY_ROWS} rows matches the host reference:"
              f" counts {got[cnt]}", flush=True)
    del port, host, hp

    loaded = [m for m, v in sys.modules.items()
              if (m == "jax" or m.startswith("jax.")) and v is not None]
    if loaded:
        raise AssertionError(f"JAX was imported: {loaded}")
    print(f"smoke run: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": launched[k.name],
        "max_abs_err": report[k.name][0], "ms": report[k.name][1],
        "plain_ms": report[k.name][2]} for k in kernels.KERNELS.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
