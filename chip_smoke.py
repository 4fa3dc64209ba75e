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
   2,000,000 parts, 8,000,000 partsupp rows, 1,500,000 customers,
   15,000,000 orders, about 60.0M lineitems, with the columns Q2-Q21
   read):
   - hash path: `hash_group_aggregate` against its plain version on Q18's
     and Q15's subqueries (equal group tables), `compact_groups` with and
     without Q18's HAVING against its plain version (equal; boolean-mask
     indexing as the yardstick; the HAVING's conjunct forms, which must
     all be direct, and the mark pass's device ms with and without it on
     the same table), then both subqueries end to end against numpy;
   - join chains: `chain_build` against its plain version on every build
     side of Q5 (equal tables; two launches a build side, the range pass
     and the insert, as the cold runs of Q3, Q4 and Q5 are held to; a side
     whose unfiltered table is fit stages that table, and its mask,
     `chain_mask`, is held to its plain version; a filtered side whose
     unfiltered table is unfit at SF10, orders, first runs a range pass
     that finds it so) and
     `chain_aggregate` against its plain
     version on Q5's walk (equal group tables), the same on Q3 (the hash
     fold) and Q4 (the SEMI build over lineitem), then Q3, Q4 and Q5 end
     to end against numpy, each with a breakdown of its time; for every
     chain query of this step and the next two, which hops its staging
     composes (hop: owner, tag) and folds (hop: the reference's span and
     width), against the SF10 expectation (supplier's hops in Q2, Q5,
     Q7-Q9 and Q21, part's fold in Q14), held to one `chain_compose` and
     one `chain_fold` launch and at most one synchronisation a chain
     staged from emptied caches (`staging_cost`). Every chain query's
     main-path run starts cold, its session's chain caches emptied: its
     first run is held to those launches and to every build side's
     (`cold_staging`; a side that comes twice in a query and is found
     staged the second time is listed in SHARED_BUILDS), and each timed
     warm run to the constant `chain_build`, `chain_compose` and
     `chain_fold` launches of WARM_STAGING (none but where a build is fed
     by a subquery or a cache cap evicts); `chain_compose` and
     `chain_fold`
     against their plain versions on Q5's staged chain (nation and
     region composed into supplier, supplier folded) and Q21's (a member
     composition), exactly, each run expecting its staging kernels
     launched;
   - row-returning join chains: `chain_rows` against its plain version
     (held to its two launches, the walk and the emit) on Q2's chain over
     partsupp (five INNER hops, the subquery's min as a
     build, a decimal residual equality) and on Q20's inner chain (an
     INNER hop on (partkey, suppkey) into the 1994 sum(l_quantity)
     aggregate, a SEMI hop into the 'forest' parts, a residual), and
     `group_emit` against its plain version on that aggregate's group
     table (millions of groups, which stay on the card); then Q2 and Q20
     end to end against numpy, with 0 fallbacks and Q20's aggregate
     taking the resident emit, each with a breakdown;
   - the full expression lowering, SEMI/ANTI min/max membership and the
     functional-dependence lane: `chain_build` against its plain version
     on Q21's builds (its two lineitem min/max tables equal;
     `scatter_reduce_` amin and amax on the packed keys as the yardstick,
     `index_put_` of the rows beside every other direct table) and
     `chain_aggregate` on every walk of Q7-Q10, Q12, Q14, Q18 (reduced)
     and Q21, then Q7, Q8, Q9, Q10, Q12, Q14, Q18 and Q21 end to end
     against numpy, with 0 fallbacks and a breakdown each; every walk of
     steps 4 and 5 is held to one launch a pass of lanes in its call and
     in its query's run;
   - the fanout-N join-aggregate and the chain's distinct lane:
     `join_build` and `join_aggregate` against their plain versions on J1
     (lineitem x partsupp on the part key: every lineitem meets its
     part's 4 partsupp rows, 239,990,660 pairs) and J2 (Q9's profit
     through (part, supplier)), `chain_aggregate` with its distinct lane
     on Q5D (Q5 with count(DISTINCT o_custkey)); then J1, J2 and Q5D end
     to end against numpy, with 0 fallbacks and a breakdown each;
   - the chain's cross-query caches and the MemoryPool (`cache_phase`):
     Q5, Q2 and Q21 each run cold after the caches are emptied, then 3
     times warm, held to WARM_STAGING (none of `chain_build`,
     `chain_compose` and `chain_fold` for Q5; for Q2 only its subquery's
     build, made anew each run; for Q21 its two min/max tables, each over
     the SEMI part's cap; the walk launched every run; one `chain_mask` a
     masked side every run), each run against numpy, with the cold and
     warm ms and the caches' bytes by part; Q5 with its dates a year
     later after its warm runs (only the orders build misses) and then Q5
     again, each timed; Q3 through its five market segments twice (no
     `chain_build` after the first run, one `chain_mask` a run, one
     unfiltered customer table in the INNER part, each run against
     numpy); Q5 with r_name ASIA, EUROPE, ASIA (each against numpy, the
     second ASIA composing and folding nothing); `chain_mask` against its
     plain version on Q3's customer and Q8's part (kernel, plain, bound
     and a floor, `torch.where` over the precomputed slot mask); Q5 under
     a GreedyMemoryPool of its build
     batches and half the caches' bytes (equal rows, the caches evicted to
     at most half), and pools one byte short of Q5's and of J1's build
     batches (ResourcesExhausted, no fallback);
   - the mesh, 4 shards of the one card (`SET datafusion.tpu.mesh_devices
     = 4`, a LocalMesh): MQ1 (Q1 over the SF10 rows of step 3: the
     all_gather aggregate), MQ15 (Q15's revenue0: the owned-slot
     shuffle), MJ1 (lineitem x partsupp, `sum(l_quantity)`: the
     partitioned join) and MB (lineitem x supplier: the broadcast join)
     against numpy, each with 0 fallbacks, its route, one cold and two
     warm runs and a breakdown; `partition_rows` (K1) against its plain
     version and a stable `torch.argsort` of the owners on MJ1's probe
     rows of shard 0 (two launches a call: the count and one sweep; MQ15
     and MJ1 held to a call a shard an exchange), and `merge_partials`
     (K2) against its plain version on every call of one run of MQ1,
     MQ15, MJ1 and MB (recorded from the main path: one launch for the 4
     local shards a merge step, as each query's runs are held to); then
     MQ1 once more
     through a one-rank NCCL `ProcessGroupMesh`, against the 4-shard rows;
   - window functions over the SF10 lineitem (with `l_returnflag`):
     W1 (top 3 by price per supplier beside each order's quantity, a
     WindowExec over two PARTITION BYs), W2 (a global row_number and lag)
     and W3 (a 7-row moving sum in 3 partition runs, a BoundedWindowExec
     over its partition-key sort): `radix_sort`, `gather_lanes` and
     `window_scan` against their plain versions on each window
     evaluation's inputs (equal; the sort also against np.lexsort's
     order; the gather's record layout and mode printed, `index_select`
     a lane as its yardstick; the scan's launches as `scan_launches`
     predicts, `index_copy_` of one int64 lane as its floor), then each
     query end to end against numpy, with its scan launches as predicted
     (no breakdown: one would run each query twice more, 30-40 s);
5. ClickBench's `UserID`, `SearchPhrase` and `EventTime` at 99,997,497
   rows (the public `hits` row count), drawn as `generate_hits` draws
   them, then `RegionID`, `AdvEngineID` and `ResolutionWidth` by its
   distributions: `hash_group_aggregate` against its plain version on Q16
   (a 2^24-slot identity table) and Q17 (42-bit keys: the probing table),
   each with `torch.unique(..., return_counts=True)` on its packed keys as
   the yardstick, `group_topk` against its plain version on Q16,
   `compact_groups` on both tables, Q16 and Q17 end to end against numpy;
   `hash_group_aggregate` with its distinct lane against its plain
   version on Q10 (equal group tables and distinct sets) and the dense
   fold's 6 passes of Q30's 180 lanes against their plain version, Q10
   and Q30 end to end against numpy (Q10's distinct counts by `np.unique`
   over the (RegionID, UserID) pairs), with the pairs, the set's bytes
   and the passes launched; then
   `radix_sort` against its plain version and np.lexsort's order
   (`lexsort_order_holds`) on Q25's and Q27's order words over the rows
   with a search phrase (equal permutations; stable
   `torch.sort` as the yardstick), and Q25, Q26 and Q27 end to end
   against numpy, with a breakdown. `group_topk`, `radix_sort`,
   `compact_groups` and `gather_lanes` are held to the launches their
   designs predict: TOPK_LAUNCHES a top-k; a histogram a word, a launch a
   varying byte and a gather a later word a sort
   (`device_sort.sort_launch_count`); 2 a compaction that keeps a group
   (Q18's subquery, CB Q17), 1 one that keeps none; and 2 a packed record
   group, 1 a direct one, of `groupby.gather_plan` (W1);
6. the entry points a user starts the port with (`entry_points_phase`):
   `python -m datafusion_tpu_torch --format csv` in a process of its own
   (`CREATE TABLE t AS` 10,000,000 rows of `generate_series`, their
   grouped count and sum against the closed form, and an EXPLAIN that must
   show `TorchGroupAggregateExec ... device=cuda`), `python -m
   datafusion_tpu_torch.bench_runner tpch --sf 0.1 --iterations 1` in
   another (its JSON line must list q1-q22), both started first; in this
   process TPC-H's 22 queries at SF 0.1 (`register_tpch`) on the card
   against a CPU session over the same tables (floats within rel 1e-9,
   some kernel launched); TPC-H Q1, Q3, Q5, Q6, Q10 and Q18 through their
   logical JSON, Substrait and physical dict and back, on the card, with
   the direct run's rows (Q18's IN subquery and the physical joins raise
   where the JAX package raises; the dict holds no device exec); and
   `LocalPod(2)`, whose workers open sessions on the card, over the
   sharded SF 0.1 `lineitem` (Q1) and `tests/test_pod.py`'s two SQL texts,
   against this process (floats within rel 1e-12). It prints each part's
   seconds.

ClickBench Q25-Q27 take a warm median of SORT_REPS runs (each spends
seconds in the host filter). Each end-to-end path sets the launch counts
to 0 just before it and reads them just after; it fails if a kernel of the path was not launched or the
exec fell back to the host (for a window, a function evaluated on the
host). Any failure raises and exits non-zero. The last line is `{"ok": true, "device": {...}}`; the line before it is the
card's name and power limit, and before that one JSON line lists every
kernel with its time, its plain version's time and its bound.

    python3 chip_smoke.py --host-joins

times J1 and J2 at SF10 once each through the port's host plan (the
device aggregate off: a numpy hash join under a numpy aggregate), each
against numpy, for the record beside the join-aggregate's times.

    python3 chip_smoke.py --sorts TREE [TREE ...]

makes the order words of CB Q25-Q27 and of W1's first window evaluation
and the group tables of CB Q16 and Q17 once (`sort_inputs`, saved under
`_chip/ab_inputs` and removed at the end), then in a process a tree
holds `radix_sort`, `reorder_rows` (W1's words through their
permutation), `group_topk` and `compact_groups` (the rebuilt tables) to
their plain versions and prints one JSON line a tree: kernel, plain,
library (`torch.sort` of the first value word, `index_select` a lane,
`torch.topk`, boolean-mask indexing) and bound ms, launches a call, each
kernel's registers and stack bytes and its device ms in one profiled
call.

    python3 chip_smoke.py --marks TREE [TREE ...]

compares kernel rows 11 and 21 across checkouts, as `--walks` does the
walks: one process a tree, each building its own kernels and making the
SF10 `tpch_tables` and `make_lineitem` rows with the same seeds, prints
one JSON line (`mark_tree`) with, on Q18's subquery, `compact_groups`
with its HAVING and without (mean device ms by CUDA events, the mark and
copy passes' profiled device ms, launches, the HAVING's conjunct forms
where the tree has them) and the query end to end; with K2 on every call
one run of MQ1, MQ15, MJ1 and MB makes on 4 shards of the card, recorded
from the tree's own entry points and replayed on fresh tables (ms a
call and a query by CUDA events, and profiled device ms; launches a run;
the host ms of one merge step's tables), each query end to end (warm
median of REPS); and the registers
and stack bytes of the compaction's and K2's kernels.

    python3 chip_smoke.py --folds TREE [TREE ...]

compares the dense fold and the join probe across checkouts, as
`--walks` does the walks: one process a tree, each building its own
kernels and making the same data, prints one JSON line with the mean
device ms (CUDA events) of `fused_dense_aggregate` on TPC-H Q1 and Q6 at
SF10 (`make_lineitem`) and ClickBench Q30 (99,997,497 rows, 180 lanes),
of the dense `chain_aggregate` walks of TPC-H Q5, Q12 and Q14 at SF10
(`time_walks`, as `--walks` times them), and of `join_build` and
`join_aggregate` (and their sum, and the build table's bytes) on J1 and
J2 at SF10; the five fold and join queries end to end (warm median of
REPS); the launches a call; and the registers and stack bytes
`cuobjdump` gives those kernels in the tree's library.

    python3 chip_smoke.py --hash TREE [TREE ...]

compares the hash group fold (`hash_group_aggregate`) across checkouts in
the same way: one process a tree, each building its own kernels and making
`hits(HITS_ROWS)` and the SF10 `tpch_tables` with the same seeds, prints
one JSON line with the mean device ms of the fold (from a pristine table)
on CB Q16, CB Q16 over a uniform `UserID` of the same users, CB Q17, CB
Q10 (its distinct lane) and Q18's and Q15's subqueries,
`torch.unique(..., return_counts=True)` on CB Q16's and Q17's packed keys,
CB Q16 and Q17 end to end (warm median of REPS), the launches a call, the
groups, and the registers and stack bytes of both variants of the kernel.

    python3 chip_smoke.py --scans TREE [TREE ...]

compares the window scan (`window_scan`) and the chain build
(`chain_build`) across checkouts in the same way: one process a tree,
each building its own kernels and making the SF10 `tpch_tables` with the
same seed, prints one JSON line with, on every window evaluation of W1,
W2 and each partition run of W3 (sorted and gathered by the tree's own
kernels), `window_scan` held to its plain version, its mean device ms
(CUDA events) and the floor beside it, `index_copy_` of one int64 lane
through the permutation; on every build side of TPC-H Q4, Q21, Q3 and
Q5, `chain_build` held to its plain version, its mean device ms and its
`build_yardstick` (`scatter_reduce_` amin and amax for a min/max table,
`index_put_` of the rows for another direct table); for each the
launches a call and the device ms of each kernel in one profiled call;
Q4 and Q21 (warm median of REPS) and W1 (one run after a warm-up) end to
end; and the registers and stack bytes of both kernels' variants.

    python3 chip_smoke.py --walks TREE [TREE ...]

compares the `chain_aggregate` walks of TPC-H Q3, Q5, Q7, Q8, Q9, Q10, Q12,
Q14, Q18 and Q21 and the `chain_rows` walks of Q2 and Q20 at SF10, and the
mesh's row partition (K1, `partition_rows`) on MJ1's and MQ15's calls,
across checkouts of the repository (for example the parent commit
unpacked with `git archive`, then this tree, then both again in reverse
order). Each TREE runs in a process of its own that imports that tree's
`datafusion_tpu_torch` and builds its kernels, makes the same SF10 tables
with this script's `tpch_tables`, and prints one JSON line: the mean
device ms of each walk over WALK_REPS calls (null where the tree does not
plan the query's chain on the card; a `chain_rows` call's time spans its
read-back of the row count), staged as the tree stages it and, in a tree
that composes, staged without composition or folding too
(`walk_ms_uncomposed`); each walk's split (`walk_split`: the walk cut at
each hop by an empty INNER table, `cut_spec`, so that cut 0 is the probe
predicate alone; the walk without its fold where its last hop is INNER;
the rows reaching and surviving each hop, from the plain walk on the
card; the launches a call; the live groups; the bound); each K1 call one
run of MJ1 and of MQ15 makes on 4 shards of the card (`k1_calls`: its
rows, destinations, cap, lanes, mean device ms and launches, and the
largest call's device ms by kernel beside a stable `torch.argsort` of its
owners); each rows walk's device ms by kernel in one profiled call
(`rows_split`); each chain's staging as the tree stages it (`staging`, from
`staging_cost`: the `chain_compose` and `chain_fold` launches and the
synchronisations that composition and folding add to its `prepare`; the
staging alone from tables staged once, through the card's finish, on one
yardstick for both trees (`stage_call`: host wall ms, median, least and
most of STAGE_REPS, and its kernels' device ms); and the spans of a
`prepare`, `dft.build` (the tables) and the staging's parts where the tree
has them); in a tree that stages a
chain in one call, each walk staged with its compositions and without
its folds (`walk_ms_composed_only`); Q2, Q5, Q7, Q8, Q9, Q12, Q14, Q20,
Q21, MJ1 and MQ15 end to end (`e2e_ms`, warm median of REPS); and the
registers and stack-frame bytes (spills included) that `cuobjdump
--dump-resource-usage` gives each walk kernel, `chain_compose`,
`chain_fold` and K1's kernels in the tree's library.
"""
import datetime
import json
import os
import statistics
import subprocess
import sys
import threading
import time

SF10_ROWS = 60_012_150       # TPC-H SF10 lineitem, DataFusion's `bench.sh tpch10`
FLOAT_ROWS = 10_000_000
FLOAT_QUERY = ("SELECT g, count(*) c, sum(v) s, avg(v) a, min(v) mn, "
               "max(v) mx FROM t GROUP BY g")
HITS_ROWS = 99_997_497       # the public ClickBench hits.parquet
REPS = 5
# W1-W3 each gather 60M rows on the host: one run, no warm-up (their
# columns are on the card from the earlier TPC-H queries)
WINDOW_REPS = 1
SORT_REPS = 1                # CB Q25-Q27 each filter 100M rows on the host
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
# ClickBench Q10 (count(DISTINCT UserID)) and Q30 (90 sums, 180 lanes)
CB_Q10 = ('SELECT "RegionID", SUM("AdvEngineID"), COUNT(*) AS c, '
          'AVG("ResolutionWidth"), COUNT(DISTINCT "UserID") FROM hits '
          'GROUP BY "RegionID" ORDER BY c DESC LIMIT 10')
CB_Q30 = "SELECT " + ", ".join(['SUM("ResolutionWidth")'] + [
    f'SUM("ResolutionWidth" + {i})' for i in range(1, 90)]) + " FROM hits"
# TPC-H Q5 with a distinct count; lineitem x partsupp, the fanout-4 part
# key (J1) and Q9's profit through the composite key (J2)
Q5D = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
       count(distinct o_custkey) as customers
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey
  and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey
  and r_name = 'ASIA'
  and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1995-01-01'
group by n_name
order by revenue desc
"""
J1 = ("SELECT ps_suppkey, count(*) AS c, sum(ps_supplycost * l_quantity) "
      "AS cost FROM lineitem JOIN partsupp ON l_partkey = ps_partkey "
      "GROUP BY ps_suppkey ORDER BY ps_suppkey")
J2 = ("SELECT ps_suppkey, sum(l_extendedprice * (1 - l_discount) - "
      "ps_supplycost * l_quantity) AS profit FROM lineitem JOIN partsupp "
      "ON ps_partkey = l_partkey AND ps_suppkey = l_suppkey "
      "GROUP BY ps_suppkey ORDER BY ps_suppkey")
# The mesh (4 shards of one card): MQ1 is Q1, MQ15 Q15's revenue0; MJ1 is
# J1 with one argument a side (the mesh refuses an argument over both
# sides, as the JAX package's DistributedJoinAggregateExec does:
# `distributed_aggregate.py:355`), partsupp's 8M rows partitioned; MB
# builds supplier's 100,000 rows and broadcasts them
MESH_SHARDS = 4
MJ1 = ("SELECT ps_suppkey, count(*) AS c, sum(l_quantity) AS qty FROM "
       "lineitem JOIN partsupp ON l_partkey = ps_partkey GROUP BY ps_suppkey "
       "ORDER BY ps_suppkey")
MB = ("SELECT s_nationkey, count(*) AS c, sum(l_extendedprice) AS price FROM "
      "lineitem JOIN supplier ON l_suppkey = s_suppkey GROUP BY s_nationkey "
      "ORDER BY s_nationkey")
MESH_RUNS = 3                # one cold run, two warm
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


def entry_bytes(t) -> int:
    """Bytes of one build table entry: the int32 row, the int64 key of a
    hashed table, the int64 min and max of a min/max table."""
    from datafusion_tpu_torch.device.join_chain import TAB_HASH
    return 4 + 8 * (t.kind == TAB_HASH) + 16 * (t.mn is not None)


def walk_bytes(spec, cols, n: int, hop_rows) -> int:
    """Bytes a chain walk over `n` spine rows must move: the spine columns
    its programs read, once; for each hop its build table (with a min/max
    table's extremes) and the payload columns the programs read, each
    entry at most once (as many as the rows that reach the hop, or survive
    it for a payload, up to the whole table or column). A composed hop
    reads its words at the owner's row, a folded one its records (which
    hold its payload). `hop_rows` is the plain walk's (rows reaching, rows
    surviving) of each hop."""
    from datafusion_tpu_torch.device.lower import OP_COL
    hop_of = spec.chain.hop_of
    read = {a for p in spec.programs() for op, a, _b in p.code
            if op == OP_COL}
    nbytes = col_bytes(cols, [i for i in read if i not in hop_of], n)
    for h, (hop, (reach, alive)) in enumerate(zip(spec.chain.hops,
                                                  hop_rows)):
        t, c, f = hop.table, hop.compose, hop.fold
        if c is not None:
            nbytes += min(reach, c.words.shape[0]) * 8 * c.width
        elif f is not None:
            nbytes += min(reach, t.size) * (8 * f.words + f.nullable *
                                            f.words + entry_bytes(t) - 4)
        else:
            nbytes += min(reach, t.size) * entry_bytes(t)
        for i in read:
            if hop_of.get(i) == h and (f is None or i not in f.columns):
                nbytes += col_bytes(cols, [i],
                                    min(alive, cols[i][0].shape[0]))
    return nbytes


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
    vectorised, with the columns that Q2-Q5, Q7-Q10, Q12, Q14, Q15, Q18,
    Q20, Q21 and W1-W3 read: `o_orderkey` is 4i - 3 and `l_orderkey` repeats it 1-7
    times (so it is sorted), foreign keys are uniform, `l_suppkey` is one
    of the 4 suppliers of a uniform `l_partkey` and `ps_suppkey` the
    supplier of each of a part's 4 `partsupp` rows (`datagen.py:161`,
    `:213`), money is Decimal(15,2), dates are Date32, `c_mktsegment`,
    `o_orderpriority`, `n_name`, `r_name`, the supplier's and the part's
    text columns (`datagen.py:115-150`) and `l_returnflag` (`datagen.py:
    223`, drawn after the other columns) are dictionary strings. Drawn
    last, so that the columns above keep their values: `l_tax`,
    `l_shipmode` (`:236`, `:241`) and `c_acctbal`; then `l_linestatus` from
    the ship date (`:225`), `o_orderstatus` and `o_totalprice` from the
    lines (`:251-256`, the total rounded half up at scale 2) and the
    customer's numbered text columns (`:176-182`). Returns {table: Batch}."""
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
        "supplier": supplier_batch(rng, n_supp),
        "customer": make_batch([
            ("c_custkey", Column(i64, np.arange(1, n_cust + 1,
                                                dtype=np.int64))),
            ("c_nationkey", Column(i64, rng.integers(0, 25, n_cust))),
            ("c_mktsegment", dict_column(G._SEGMENTS,
                                         rng.integers(0, 5, n_cust)))]),
    }
    out["part"], out["partsupp"] = part_batches(rng, n_part, n_supp,
                                                per_part)
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
    del which
    ship = (l_odate + rng.integers(1, 122, n)).astype(np.int32)
    commit = (l_odate + rng.integers(30, 91, n)).astype(np.int32)
    receipt = (ship + rng.integers(1, 31, n)).astype(np.int32)
    del l_odate
    out["lineitem"] = make_batch([
        ("l_orderkey", Column(i64, np.repeat(ok, n_lines))),
        ("l_partkey", Column(i64, part)),
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
    tax = rng.integers(0, 9, n)
    mode = rng.integers(0, len(G._SHIPMODES), n)
    acctbal = rng.integers(-99_999, 1_000_000, n_cust)
    late = ship > G._days(1995, 6, 17)           # linestatus O, else F
    starts = np.r_[0, np.cumsum(n_lines)[:-1]]
    total = np.add.reduceat(price * (100 - col(out["lineitem"],
                                               "l_discount")) * (100 + tax),
                            starts)
    n_open = np.add.reduceat(late.astype(np.int64), starts)
    out["lineitem"] = add_columns(out["lineitem"], [
        ("l_tax", Column(dec2, tax)),
        ("l_linestatus", dict_column(["F", "O"], late.astype(np.int64))),
        ("l_shipmode", dict_column(G._SHIPMODES, mode))])
    out["orders"] = add_columns(out["orders"], [
        ("o_orderstatus", dict_column(["F", "O", "P"], np.where(
            n_open == 0, 0, np.where(n_open == n_lines, 1, 2)))),
        ("o_totalprice", Column(dec2, (total + 5000) // 10000))])
    ck = col(out["customer"], "c_custkey")
    every = np.arange(n_cust)
    out["customer"] = add_columns(out["customer"], [
        ("c_name", dict_column(G._numbered("Customer#", ck, 9), every)),
        ("c_address", dict_column(G._numbered("caddr", ck, 0), every)),
        ("c_phone", dict_column(G._phones(
            rng, col(out["customer"], "c_nationkey"), ck), every)),
        ("c_acctbal", Column(dec2, acctbal)),
        ("c_comment", dict_column(G._numbered(
            "customer comment ", np.arange(1000), 0), ck % 1000))])
    return out


def add_columns(batch, cols):
    """`batch` with the columns [(name, column)] appended."""
    return make_batch([(f.name, c) for f, c in zip(batch.schema.fields,
                                                    batch.columns)] + cols)


def supplier_batch(rng, n_supp: int):
    """`supplier` by `datagen.py:112-126`: names, addresses, phones and
    comments numbered by key, a uniform nation, Decimal(15,2) balances."""
    import numpy as np
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.column import Column
    from datafusion_tpu_torch.tpch import datagen as G
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    nation = rng.integers(0, 25, n_supp)
    every = np.arange(n_supp)

    def text(values):
        return dict_column(values, every)
    return make_batch([
        ("s_suppkey", Column(dt.INT64, sk)),
        ("s_name", text(G._numbered("Supplier#", sk, 9))),
        ("s_address", text(G._numbered("addr", sk, 0))),
        ("s_nationkey", Column(dt.INT64, nation.astype(np.int64))),
        ("s_phone", text(G._phones(rng, nation, sk))),
        ("s_acctbal", Column(dt.decimal(15, 2),
                             rng.integers(-99_999, 1_000_000, n_supp))),
        ("s_comment", text(G._numbered("supplier comment ", sk % 1000,
                                       0)))])


def part_batches(rng, n_part: int, n_supp: int, per_part: int):
    """`part` and `partsupp` by `datagen.py:129-169`: a name of two colours,
    a manufacturer, a type of three syllables and a size 1-50 for each
    part; 4 suppliers a part, with an available quantity 1-9999 and a
    Decimal(15,2) cost 1.00-1000.00."""
    import numpy as np
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.column import Column
    from datafusion_tpu_torch.tpch import datagen as G
    pk = np.arange(1, n_part + 1, dtype=np.int64)
    nc = len(G._COLORS)
    names = [f"{a} {b}" for a in G._COLORS for b in G._COLORS]
    types = [f"{a} {b} {c}" for a in G._TYPE_S1 for b in G._TYPE_S2
             for c in G._TYPE_S3]
    part = make_batch([
        ("p_partkey", Column(dt.INT64, pk)),
        ("p_name", dict_column(names, rng.integers(0, nc, n_part) * nc +
                               rng.integers(0, nc, n_part))),
        ("p_mfgr", dict_column([f"Manufacturer#{m}" for m in range(1, 6)],
                               rng.integers(0, 5, n_part))),
        ("p_type", dict_column(types, rng.integers(0, len(types), n_part))),
        ("p_size", Column(dt.INT32, rng.integers(1, 51, n_part)
                          .astype(np.int32)))])
    ps_part = np.repeat(pk, per_part)
    n_ps = len(ps_part)
    ps_supp = ((ps_part - 1 + (np.arange(n_ps) % per_part) *
                (n_supp // per_part + 1)) % n_supp) + 1
    partsupp = make_batch([
        ("ps_partkey", Column(dt.INT64, ps_part)),
        ("ps_suppkey", Column(dt.INT64, ps_supp)),
        ("ps_availqty", Column(dt.INT32, rng.integers(1, 10_000, n_ps)
                               .astype(np.int32))),
        ("ps_supplycost", Column(dt.decimal(15, 2),
                                 rng.integers(100, 100_001, n_ps)))])
    return part, partsupp


def hits(n: int, seed: int = 0):
    """`UserID` and `SearchPhrase` as `generate_hits` draws them (its first
    three draws: zipf(1.3), random, zipf(1.5); `clickbench/workload.py:
    15-26`), with the dictionary sorted as `register_hits` sorts it, then
    `EventTime` as it draws it (`:81`: 2013-07-01 plus up to 31 days of
    seconds), then `RegionID`, `AdvEngineID` and `ResolutionWidth` by its
    distributions (`:72-74`, `:86-87`: uniform on [0, 5000); 0 with
    probability 0.95, else uniform on [1, 20); one of 8 screen widths)."""
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
    region = rng.integers(0, 5000, n).astype(np.int64)
    adv = np.where(rng.random(n) < 0.95, 0,
                   rng.integers(1, 20, n)).astype(np.int64)
    width = rng.choice([1024, 1280, 1366, 1440, 1536, 1600, 1920, 2560],
                       n).astype(np.int64)
    return make_batch([("UserID", Column(dt.INT64, user)),
                       ("SearchPhrase", dict_column(phrases, idx)),
                       ("EventTime", Column(dt.INT64, event)),
                       ("RegionID", Column(dt.INT64, region)),
                       ("AdvEngineID", Column(dt.INT64, adv)),
                       ("ResolutionWidth", Column(dt.INT64, width))])


def col(batch, name):
    return batch.column_by_name(name).data_host()


# ---- the main path ----------------------------------------------------------

def clear_chain_caches(ex, staged=()):
    """Empties the chain caches of the chain exec `ex` and the stats kept
    with the staged builds `staged`, so that what is timed next stages as
    a cold query does (nothing in a tree without the caches)."""
    caches = getattr(ex, "chain_caches", None)
    if caches is not None:
        caches.clear()
    for s in staged:
        if hasattr(s, "stats"):
            s.stats = {}


def cache_bytes(caches) -> dict:
    """The caches' device bytes by part, and their total."""
    out = {k: p.nbytes for k, p in caches.parts.items()}
    out["total"] = caches.device_cache_bytes()
    return out


def chain_execs(ctx, sql):
    """Every join chain exec of the query's plan."""
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchChainExec)

    def walk(node):
        yield node
        for c in node.children():
            yield from walk(c)
    return [n for n in walk(ctx.sql(sql).create_physical_plan())
            if isinstance(n, TorchChainExec)]


STAGING = ("chain_build", "chain_compose", "chain_fold", "chain_mask")

# label -> the build sides of the query that its first run after the chain
# caches are emptied finds there, because an earlier side of the same run
# staged the same table: (join type, key columns, predicate text), as
# `side_name` names them. Q7 and Q8 join nation twice; Q2's subquery and
# its outer chain both join supplier, nation and region (r_name = EUROPE:
# one unfiltered table, masked at each of its two uses).
SHARED_BUILDS = {
    "Q2 SF10": {("INNER", "s_suppkey", "None"),
                ("INNER", "n_nationkey", "None"),
                ("INNER", "r_regionkey", '(r_name = Utf8("EUROPE"))')},
    "Q7 SF10": {("INNER", "n_nationkey", "None")},
    "Q8 SF10": {("INNER", "n_nationkey", "None")},
}

# label -> the `chain_build`, `chain_compose` and `chain_fold` launches of
# each warm run (the caches filled by the run before); a chain query not
# named here launches none of them. Every run, warm or cold, launches one
# `chain_mask` for each eligible filtered build side (`build_sides`).
WARM_STAGING = {
    # the build fed by the subquery's aggregate has new columns every run,
    # and the composition into it and its fold are staged again with it
    "Q2 SF10": {"chain_build": 2, "chain_compose": 1, "chain_fold": 1},
    # the SEMI build fed by the HAVING subquery's aggregate, made anew
    "Q18 SF10": {"chain_build": 2, "chain_compose": 0, "chain_fold": 0},
    # the INNER build fed by the subquery's aggregate, made anew
    "Q20 SF10": {"chain_build": 2, "chain_compose": 0, "chain_fold": 0},
    # orders' unfiltered table (240,000,000 bytes) and partsupp's
    # (201,326,592) do not fit the INNER part's 256 MiB together: each
    # insert evicts from the oldest end, so every run rebuilds all five
    # tables (part's unfiltered one among them) and stages the words and
    # records read from them again
    "Q9 SF10": {"chain_build": 10, "chain_compose": 1, "chain_fold": 1},
    # lineitem's two min/max tables, 1,199,999,940 bytes each, are each
    # over the SEMI part's 1 GiB: each insert evicts the other
    "Q21 SF10": {"chain_build": 4, "chain_compose": 0, "chain_fold": 0},
}


def side_name(b):
    """A build side by its join type, its key columns and its predicate's
    text, columns by name (not by their position in the side)."""
    import re
    from datafusion_tpu_torch.physical.physical_optimizer import _unwrap_side
    un = _unwrap_side(b.source)
    pred = None if un is None else un[1]
    return (b.join_type,
            ", ".join(re.sub(r"@\d+", "", str(k)) for k in b.build_keys),
            re.sub(r"@\d+", "", str(pred)))


def masked(s) -> bool:
    """Whether the staged build side `s` took an unfiltered table and
    masked it by its predicate (`chain_mask`)."""
    base = getattr(s, "base", None)
    return base is not None and s.table is not base


def side_launches(s, caches, seen, known=()):
    """`chain_build` launches of staging the build side `s` from emptied
    caches: the range pass, and the insert unless the table is empty, of
    its unfiltered table when it took one (none when an earlier side of
    the run, in `seen`, staged it), else of its own table, plus for a
    filtered side whose unfiltered table was found unfit the attempt
    (`caches.ineligible`: the range pass for too wide a span, both passes
    for a duplicate key), unless an earlier side made it or its key is in
    `known`. Adds the side's unfiltered key to `seen`."""
    from datafusion_tpu_torch.device.join_chain import TAB_EMPTY
    n = s.batch.num_rows
    key = getattr(s, "lut_key", None)
    first = key is not None and key not in seen and key not in known
    if key is not None:
        seen.add(key)
    base = getattr(s, "base", None)
    if base is not None:
        return ((n > 0) + (base.kind != TAB_EMPTY)) if first else 0
    why = caches.ineligible.get(key) if first else None
    extra = {"span": 1, "duplicate": 2}.get(why, 0) \
        if s.spec.pred is not None else 0
    return (n > 0) + (s.table.kind != TAB_EMPTY) + extra


def build_sides(ex, tctx, known=(), found=None):
    """([(side_name, `chain_build` launches, whether it is masked)] of each
    build side of the chain exec `ex`, staged from emptied caches
    (`side_launches`, `known` the unfiltered keys taken as found unfit
    already); {hop: (owner, tag)} of the hops its staging composes; {hop:
    budget} of those it folds). The unfiltered keys found unfit are added
    to `found`, when given."""
    clear_chain_caches(ex)
    staged = ex.stage_builds(tctx, compose=False)
    composed, folded = ex.compose_plan(staged)
    if found is not None:
        found.update(ex.chain_caches.ineligible)
    seen = set()
    sides = [(side_name(b), side_launches(s, ex.chain_caches, seen, known),
              masked(s)) for b, s in zip(ex.builds, staged)]
    clear_chain_caches(ex, staged)
    return sides, composed, folded


def cold_staging(ctx, sql, tctx, label, builds=None):
    """{kernel: launches} of `chain_build`, `chain_compose`, `chain_fold`
    and `chain_mask` in a run of `sql` after its session's chain caches
    are emptied: every build side's (`build_sides`), a side whose (join
    type, keys, predicate) came earlier in the run counted only if
    SHARED_BUILDS does not list it as found staged (a repeat it does not
    list fails); one compose and one fold launch a chain that composes and
    folds; one mask a masked side, repeats included. With
    `builds` (`chain_builds_vs_plain`'s count of the launches of each
    build side, one by one), fails unless the `chain_build` count is
    that."""
    out = dict.fromkeys(STAGING, 0)
    seen = set()
    shared = SHARED_BUILDS.get(label, set())
    for ex in chain_execs(ctx, sql):
        sides, composed, folded = build_sides(ex, tctx)
        for name, n, mask in sides:
            out["chain_mask"] += mask
            if name in seen:
                if name not in shared:
                    raise AssertionError(f"{label}: build side {name} comes "
                                         f"twice; SHARED_BUILDS lists "
                                         f"{sorted(shared)}")
                continue
            seen.add(name)
            out["chain_build"] += n
        out["chain_compose"] += bool(composed)
        out["chain_fold"] += bool(folded)
    if shared - seen:
        raise AssertionError(f"{label}: SHARED_BUILDS names {shared - seen}, "
                             f"which no build side is")
    if builds is not None and out["chain_build"] != builds:
        raise AssertionError(f"{label}: {out['chain_build']} build launches "
                             f"from empty caches, not the {builds} counted "
                             f"side by side")
    return out


def warm_staging(label, masks):
    """WARM_STAGING[label], or no staging launch, with `masks` (the cold
    run's) `chain_mask` launches."""
    out = dict.fromkeys(STAGING, 0)
    out.update(WARM_STAGING.get(label, {}))
    out["chain_mask"] = masks
    return out


def run_path(ctx, sql, expect, card, label, rows, cls=None, reps=REPS,
             warm=True, cold=None):
    """The main path: launch counts set to 0, a warm-up (unless not
    `warm`) and `reps` timed runs, counts read. Fails unless every kernel
    of `expect` launched and no exec of `cls` (by default
    TorchGroupAggregateExec) fell back. With `cold` (a query with join
    chains: its `chain_build`, `chain_compose` and `chain_fold` launches
    from empty caches, `cold_staging`), the warm-up is a cold run: the
    session's chain caches are emptied before it and it is held to
    `cold`; each timed run is held to `warm_staging(label)`. Returns
    (result batch, launches, ms)."""
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    cls = cls or TorchGroupAggregateExec
    kernels.reset_launch_counts()
    if cold is not None:
        ctx.chain_caches.clear()
    if warm:
        t0 = time.perf_counter()
        out = ctx.sql(sql).collect_batch()            # warm-up
        cold_ms = (time.perf_counter() - t0) * 1e3
    if cold is not None:
        got_cold = {k: kernels.launch_counts()[k] for k in STAGING}
        if got_cold != cold:
            raise AssertionError(f"{label}: the cold run launched "
                                 f"{got_cold}, not {cold}")
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
    per_query = {k: launches[k] / (reps + warm) for k in expect}
    cached = ""
    if cold is not None:
        got = {k: launches[k] - cold[k] for k in STAGING}
        want = {k: n * reps for k, n in
                warm_staging(label, cold["chain_mask"]).items()}
        if got != want:
            raise AssertionError(f"{label}: {reps} warm runs launched {got}, "
                                 f"not {want}")
        cached = (f"; cold run {cold_ms:.3f} ms launching {cold}, warm "
                  f"runs {got} as held, chain caches "
                  f"{cache_bytes(ctx.chain_caches)} bytes")
    print(f"{label} end to end: {'warm ' if warm else ''}median of {reps} "
          f"{med:.3f} ms, "
          f"{rows / (med / 1e3):.1f} rows/s, launches per query "
          f"{per_query}, fallbacks {fallbacks}{cached} [{card}]", flush=True)
    return out, launches, med


def no_fallbacks(ctx, sql, label):
    """Fails unless every device exec of the query's plan ran on the card."""
    def walk(node):
        yield node
        for c in node.children():
            yield from walk(c)
    fell = [type(n).__name__ for n in walk(ctx.sql(sql).create_physical_plan())
            if getattr(n, "fallbacks", 0)]
    if fell:
        raise AssertionError(f"{label}: {fell} fell back to the host")


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
    return spans


# ---- kernels against their plain versions -----------------------------------

def kernel_vs_plain(ctx, sql, table_name, float_rel, reps=(20, 3)):
    """Kernel and plain version of the query's dense aggregate on the same
    staged inputs, timed over `reps` (kernel, plain) runs. Returns the
    kernel's report entry."""
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
    ms = cuda_ms(lambda: dense_group_aggregate(spec, cols, aux, n, t_k),
                 reps[0])
    t_p = spec.new_table(dev)
    plain_ms = cuda_ms(
        lambda: dense_group_aggregate_plain(spec, cols, aux, n, t_p), reps[1])
    bnd = bound(col_bytes(cols, spec.pools.columns, n) + t_k.numel() * 8,
                prog_ops(spec, n))
    return entry(err, ms, plain_ms, bnd)


def unique_yardstick(spec, cols, aux, n, groups, label):
    """The mean device ms of `torch.unique(keys, return_counts=True)` (a
    sort and a run-length count: one PyTorch call that computes a
    count-only group table) on the staged packed keys of the rows that pass
    the spec's predicate, made with torch ops outside the timed region (so
    the call leaves out the key program); fails unless it finds `groups`
    keys."""
    import torch
    from datafusion_tpu_torch.device.groupby import _rows_and_keys
    valid, packed = _rows_and_keys(spec, cols, aux, n)
    keys = packed[valid]
    del valid, packed
    found = torch.unique(keys, return_counts=True)[0].numel()
    if found != groups:
        raise AssertionError(f"{label}: torch.unique found {found} keys, "
                             f"the kernel {groups}")
    ms = cuda_ms(lambda: torch.unique(keys, return_counts=True), 5)
    del keys
    torch.cuda.empty_cache()
    return ms


def hash_kernel_vs_plain(ctx, sql, label, card, having=False, library=False):
    """`hash_group_aggregate` against its plain version on the query's
    staged inputs (equal group tables, ordered by key), and with `having`
    `compact_groups` with the query's HAVING against its plain version
    (equal, column for column); with `library`, `torch.unique` on the
    packed keys as its yardstick (`unique_yardstick`). Returns (kernel 2's
    report entry, kernel 3's with HAVING or None, kernel 3's without, the
    kernel's table, spec, lane names)."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        compact_groups_plain, hash_group_aggregate,
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
    lib2 = unique_yardstick(spec, cols, aux, n, groups, label) \
        if library else None
    print(f"hash_group_aggregate {label}: {n} rows, {groups} groups, "
          f"{spec.cap} slots ({'identity' if spec.identity_slots else 'hashed'})"
          f": kernel {ms2:.6f} ms, plain {plain2:.6f} ms, bound "
          f"{b2['bound_ms']:.6f} ms, torch.unique "
          f"{'none' if lib2 is None else f'{lib2:.6f} ms'}, max_abs_err "
          f"{err2} [{card}]", flush=True)
    table = tables[0]
    kc, _launches = compaction_vs_plain(table, None, label, card)
    k3 = None
    if having:
        from datafusion_tpu_torch.device.groupby import HAVING_DIRECT
        hv = ex.having(spec, plan, names, slot_map)
        if hv.mode != HAVING_DIRECT:
            raise AssertionError(f"{label}: its HAVING runs the interpreter: "
                                 f"{hv.forms}")
        k3, _launches = compaction_vs_plain(table, hv, label, card,
                                            groups * len(hv.prog.code))
    return entry(err2, ms2, plain2, b2, lib2), k3, kc, table, spec, names


def compaction_vs_plain(table, having, label, card, ops=None,
                        predicted=True):
    """`compact_groups` (kernel rows 2 and 11) against its plain version on
    `table`, with or without `having`: equal column for column; with
    `predicted`, launched 2 times a call (1 when nothing is kept). With no
    HAVING, boolean-mask indexing by the occupied slots is the library
    yardstick. Bound: the key row read once, the rest of each live slot's
    rows read once, the kept groups written once. Returns (the report
    entry, its launches a call)."""
    import torch
    from datafusion_tpu_torch.device.groupby import (
        compact_groups, compact_groups_kernel, compact_groups_plain)
    before = compact_groups_kernel.launches
    got = compact_groups(table, having)
    launches = compact_groups_kernel.launches - before
    want = compact_groups_plain(table, having)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{label}: compact_groups differs from its "
                             f"plain version")
    kept = want.shape[1]
    if predicted and launches != (2 if kept else 1):
        raise AssertionError(f"{label}: compact_groups counted {launches} "
                             f"launches")
    del got, want
    rows, cap = table.shape
    groups = int((table[0] != -1).sum())
    ms = cuda_ms(lambda: compact_groups(table, having), 10)
    plain = cuda_ms(lambda: compact_groups_plain(table, having), 3)
    library = None
    if having is None:
        library = cuda_ms(lambda: table[:, table[0] != -1], 10)
    # the key row; what a HAVING must read; the rest of the kept groups'
    # rows; the output
    hbytes, read = (0, 0) if having is None else having_reads(table, having)
    bnd = bound(cap * 8 + hbytes + kept * (rows - 1 - read) * 8 +
                kept * rows * 8, cap if ops is None else ops)
    what = "no HAVING" if having is None else "with HAVING"
    if having is not None:
        split = kernel_ms(lambda: compact_groups(table, having), 10)
        floor = kernel_ms(lambda: compact_groups(table), 10)
        mark, mark0 = (sum(v for k, v in d.items() if "compact_mark" in k)
                       for d in (split, floor))
        mode = {1: "direct, inline", 2: "a slot at a time"}[having.mode]
        print(f"compact_groups {label}: HAVING conjuncts {having.forms} "
              f"({mode}): the mark pass {mark:.6f} ms with the HAVING, "
              f"{mark0:.6f} ms without it on the same table (device ms, "
              f"profiled, mean of 10) [{card}]", flush=True)
    print(f"compact_groups {label}, {what}: {kept} kept of {groups} groups "
          f"in {cap} slots, {launches} launches a call: kernel {ms:.6f} ms, "
          f"plain {plain:.6f} ms, boolean-mask indexing "
          f"{'-' if library is None else f'{library:.6f}'} ms, bound "
          f"{bnd['bound_ms']:.6f} ms, max_abs_err 0.0 [{card}]", flush=True)
    return entry(0.0, ms, plain, bnd, library), launches


def having_reads(table, having):
    """(bytes, rows): what `having` must read of `table` beside the key
    row, and how many of the table's rows that touches. Its conjuncts run
    in the descriptor's order, each on the groups that passed those before
    it. A count, a sum, or a min or max without a NaN count, tested against
    a constant or an IN list, reads its value row there and its count row
    only at the groups that pass it; any other conjunct reads every row of
    its columns there. A row is counted where it is first read: the groups
    a later conjunct reads are among those."""
    import copy
    from datafusion_tpu_torch.device.groupby import (
        FIN_COUNT, FIN_KEY, FIN_MAX, FIN_MIN, FIN_SUM)
    from datafusion_tpu_torch.device.lower import (
        CJ_CMP_F, CJ_CMP_I, CJ_CMPC_F, CJ_CMPC_I, CJ_IN_F, CJ_IN_I, OP_COL)
    alive = table[0] != -1
    nbytes, rows = 0, set()
    for form, c in having.conjuncts:
        one = copy.copy(having)
        one.conjuncts = [(form, c)]
        ok = alive & one.mask(table)
        n_alive, n_ok = int(alive.sum()), int(ok.sum())
        if form is None:
            idxs = {a for op, a, _b in c.code if op == OP_COL}
        else:
            idxs = {form[1]} | ({form[3]} if form[0] in (CJ_CMPC_I,
                                                         CJ_CMPC_F) else set())
        lean = form is not None and form[0] in (CJ_CMP_I, CJ_CMP_F, CJ_IN_I,
                                                CJ_IN_F)
        for i in idxs:
            f = having.fins[i]
            w = f.words
            if f.kind == FIN_KEY:
                continue
            if f.kind == FIN_COUNT:
                at = {w[0]: n_alive}
            elif lean and (f.kind == FIN_SUM or
                           f.kind in (FIN_MIN, FIN_MAX) and w[3] < 0):
                at = {w[0]: n_alive, w[1]: n_ok}
            else:
                at = {r: n_alive for r in (w[0], w[1], *w[3:4]) if r > 0}
            for r, n in at.items():
                if r not in rows:
                    rows.add(r)
                    nbytes += 8 * n
        alive = ok
    return nbytes, len(rows)


def gather_vs_plain(perm, lanes, card, label):
    """`reorder_rows` (kernel row 8) of the lanes through `perm` against
    its plain version (equal), with `index_select` a lane as the library
    yardstick. Bound: the index read once, each lane read and written once
    (it counts no random sectors). Returns the report entry with its
    launches a call and its device ms by kernel."""
    import torch
    from datafusion_tpu_torch.device.groupby import (
        gather_lanes_kernel, reorder_rows, reorder_rows_plain)
    before = gather_lanes_kernel.launches
    got = reorder_rows(perm, lanes)
    launches = gather_lanes_kernel.launches - before
    for g, p in zip(got, reorder_rows_plain(perm, lanes)):
        if not torch.equal(g, p):
            raise AssertionError(f"{label}: gather_lanes differs from its "
                                 f"plain version")
    del got
    n = perm.numel()
    ms = cuda_ms(lambda: reorder_rows(perm, lanes), 10)
    plain = cuda_ms(lambda: reorder_rows_plain(perm, lanes), 3)
    library = cuda_ms(lambda: [t.index_select(0, perm) for t in lanes], 10)
    width = sum(t.element_size() for t in lanes)
    bnd = bound(n * 8 + 2 * n * width, 0)
    print(f"gather_lanes {label}: {n} rows, {len(lanes)} lanes of {width} "
          f"B, {launches} launches a call: kernel {ms:.6f} ms, plain "
          f"{plain:.6f} ms, index_select {library:.6f} ms, bound "
          f"{bnd['bound_ms']:.6f} ms, max_abs_err 0.0 [{card}]", flush=True)
    return dict(launches=launches, **entry(0.0, ms, plain, bnd, library),
                device_ms=kernel_ms(lambda: reorder_rows(perm, lanes)))


def topk_bound(table, row: int, k: int) -> dict:
    """The least time of a top-k of a group table by its row `row`: the key
    row read once, the 32-byte sectors of the lane that hold a live slot
    (this table's, counted), and k slots written."""
    import torch
    live = (table[0] != -1).nonzero().squeeze(1)
    sectors = int(torch.unique_consecutive(live // 4).numel())
    return bound(table.shape[1] * 8 + sectors * 32 + k * 8, table.shape[1])


def topk_vs_plain(table, lane, names, card, label, predicted=True):
    """`group_topk` against its plain version (the order column exactly,
    the key set beyond the k-th value), and `torch.topk` over the same row
    as the library yardstick; with `predicted` its launches a call held to
    TOPK_LAUNCHES. Returns (the kernel's report entry, its launches)."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        compact_groups_plain, group_topk, group_topk_kernel,
        group_topk_plain)
    row = 2 + names.index(lane)
    before = group_topk_kernel.launches
    slots = group_topk(table, row, False, 10)
    launches = group_topk_kernel.launches - before
    if predicted:
        from datafusion_tpu_torch.device.groupby import TOPK_LAUNCHES
        if launches != TOPK_LAUNCHES:
            raise AssertionError(f"{label}: group_topk counted {launches} "
                                 f"launches, not {TOPK_LAUNCHES}")
    got = compact_groups_plain(table, slots=slots)
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
    bnd = topk_bound(table, row, 10)
    print(f"group_topk {label}: top 10 counts {wv[::-1].tolist()}, "
          f"{launches} launches a call: kernel {ms:.6f} ms, plain "
          f"{plain:.6f} ms, torch.topk {library:.6f} ms, bound "
          f"{bnd['bound_ms']:.6f} ms ({bnd['bytes']} bytes), max_abs_err "
          f"0.0 [{card}]", flush=True)
    return entry(0.0, ms, plain, bnd, library), launches


def check_build(bi, label, spec=None):
    """`chain_build` against its plain version on the build side `bi`,
    staged by `spec` (by default its own; its unfiltered one for a side
    that takes an unfiltered table): the same kind, ranges, shifts, live
    rows and duplicate flag, the same keys, for an INNER build the same
    row of each key, for a min/max build the same extremes of each key.
    Returns the kernel's table."""
    import numpy as np
    from datafusion_tpu_torch.device.join_chain import (
        chain_build, chain_build_plain)
    n = bi.batch.num_rows
    spec = spec or bi.spec
    got = chain_build(spec, bi.cols, bi.aux, n, bi.unique)
    want = chain_build_plain(spec, bi.cols, bi.aux, n, bi.unique)

    def shape(t):
        return (t.kind, t.los, t.his, t.shifts, t.size, t.live, t.duplicate)
    gk, gr = got.entries()
    wk, wr = want.entries()
    # a SEMI or ANTI build stores presence: of a key's rows, either
    # version may keep any one
    mmx = got.mn is not None
    if shape(got) != shape(want) or not np.array_equal(gk, wk) or \
            (bi.unique and not np.array_equal(gr, wr)) or \
            mmx != (want.mn is not None) or (mmx and not all(
                np.array_equal(a, b) for a, b in zip(
                    got.extremes(), want.extremes()))):
        raise AssertionError(f"{label}: chain_build differs from its plain "
                             f"version: {shape(got)} {shape(want)}")
    return got


def build_yardstick(bi, table, reps=5, spec=None):
    """The one PyTorch call that computes a direct build table from the
    packed keys of its live rows (the programs left out, as
    `unique_yardstick` leaves out the key program): for a min/max build
    `scatter_reduce_` "amin" and "amax" of the member into the extremes,
    else `index_put_` of the rows. {call: mean device ms}, and "ms" their
    sum; None for a hashed or empty table, whose slots are no function of
    the key alone."""
    import torch
    from datafusion_tpu_torch.device.join_chain import TAB_DIRECT
    from datafusion_tpu_torch.device.lower import evaluate
    if table.kind != TAB_DIRECT:
        return None
    spec = spec or bi.spec
    cols, aux, n = bi.cols, bi.aux, bi.batch.num_rows
    live = torch.ones(n, dtype=torch.bool, device=aux.device)
    if spec.pred is not None:
        d, v = evaluate(spec.pred, cols, aux, n)
        live &= (d != 0) & v
    packed = torch.zeros(n, dtype=torch.int64, device=aux.device)
    for prog, lo, shift in zip(spec.key_programs(), table.los, table.shifts):
        d, v = evaluate(prog, cols, aux, n)
        live &= v
        packed |= (d - lo) << shift
    member = None
    if spec.member is not None:
        member, v = evaluate(spec.member, cols, aux, n)
        live &= v
        member = member[live]
    packed = packed[live]
    out = {}
    if member is not None:
        ext = torch.empty(table.size, dtype=torch.int64, device=aux.device)
        for how in ("amin", "amax"):
            out[f"scatter_reduce_ {how}"] = cuda_ms(
                lambda: ext.scatter_reduce_(0, packed, member, how), reps)
    else:
        rows = torch.nonzero(live).squeeze(1).to(torch.int32)
        tab = torch.empty(table.size, dtype=torch.int32, device=aux.device)
        out["index_put_"] = cuda_ms(lambda: tab.index_put_((packed,), rows),
                                    reps)
    out["ms"] = sum(out.values())
    return out


def chain_builds_vs_plain(ex, tctx, card, label, mmx_only=False):
    """`check_build` on every build side of the chain exec `ex` as a cold
    run stages it (of a side that takes an unfiltered table, that table,
    and its mask by `check_mask`), each timed beside its plain version
    and, for a direct table, its `build_yardstick`, and held to the
    launches its design predicts: the range pass and the insert, no insert
    for an empty table. Returns the report entry of the largest build side
    (with `mmx_only`, of the largest min/max build side) and the launches
    a cold run of the query predicts (`side_launches`)."""
    from datafusion_tpu_torch.device.join_chain import (
        TAB_EMPTY, chain_build, chain_build_kernel, chain_build_plain)
    from datafusion_tpu_torch.device.lower import OP_COL
    best, predicted, seen = None, 0, set()
    clear_chain_caches(ex)
    staged = ex.stage_builds(tctx, compose=False)
    for h, bi in enumerate(staged):
        n = bi.batch.num_rows
        spec = bi.spec if getattr(bi, "base", None) is None \
            else bi.spec.unfiltered()
        before = chain_build_kernel.launches
        got = check_build(bi, f"{label} build {h}", spec)
        launches = chain_build_kernel.launches - before
        want = (n > 0) + (got.kind != TAB_EMPTY)
        if launches != want:
            raise AssertionError(f"{label} build {h}: chain_build counted "
                                 f"{launches} launches, not {want}")
        predicted += side_launches(bi, ex.chain_caches, seen)
        if masked(bi):
            check_mask(bi, f"{label} build {h}")
        mmx = got.mn is not None
        ms = cuda_ms(lambda: chain_build(spec, bi.cols, bi.aux, n,
                                         bi.unique), 5)
        plain = cuda_ms(lambda: chain_build_plain(spec, bi.cols, bi.aux,
                                                  n, bi.unique), 2)
        lib = build_yardstick(bi, got, spec=spec)
        # inputs read once, the table written once
        read = {a for p in spec.programs() for op, a, _b in p.code
                if op == OP_COL}
        nbytes = col_bytes(bi.cols, read, n) + got.size * entry_bytes(got)
        bnd = bound(nbytes, prog_ops(spec, n))
        kind = ["direct", "hashed", "empty"][got.kind]
        print(f"chain_build {label} build {h}: {n} rows, {got.live} live, "
              f"{kind}{' min/max' if mmx else ''}"
              f"{' unfiltered' if spec is not bi.spec else ''} table of "
              f"{got.size} slots: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
              f"bound {bnd['bound_ms']:.6f} ms, library {lib}, max_abs_err "
              f"0 [{card}]", flush=True)
        if (mmx or not mmx_only) and (best is None or n > best[0]):
            best = (n, entry(0.0, ms, plain, bnd,
                             None if lib is None else lib["ms"]))
        del got
    clear_chain_caches(ex, staged)
    return best[1], predicted


def check_mask(bi, label):
    """`chain_mask` against its plain version on the masked build side
    `bi`: the same rows, exactly, as the table the run masked, the
    unfiltered table's layout. Returns (the mask's spec, the kernel's
    table)."""
    import torch
    from datafusion_tpu_torch.device.join_chain import (
        MaskSpec, chain_mask, chain_mask_plain)
    spec = MaskSpec(bi.spec.pools, bi.spec.pred)
    base, n = bi.base, bi.batch.num_rows
    got = chain_mask(spec, bi.cols, bi.aux, n, base)
    want = chain_mask_plain(spec, bi.cols, bi.aux, n, base)
    layout = (base.kind, base.los, base.his, base.shifts, base.size)
    if not (torch.equal(got.rows, want.rows) and
            torch.equal(got.rows, bi.table.rows)) or \
            (got.kind, got.los, got.his, got.shifts, got.size) != layout:
        raise AssertionError(f"{label}: chain_mask differs from its plain "
                             f"version")
    return spec, got


def mask_vs_plain(bi, card, label):
    """`check_mask` on the masked build side `bi`, timed (CUDA events, and
    the kernel alone by the profiler) beside its plain version and a
    floor, `torch.where` over the slots'
    mask precomputed (the predicate and its gather left out: no PyTorch
    call evaluates a predicate). The bound: the unfiltered table's rows
    read and the masked rows written once, the predicate's columns read
    once over the build rows, its program run once a row. Returns the
    kernels line's entry (the floor as `floor_ms`; no library call
    computes the mask)."""
    import torch
    from datafusion_tpu_torch.device.join_chain import (
        chain_mask, chain_mask_kernel, chain_mask_plain)
    from datafusion_tpu_torch.device.lower import OP_COL, evaluate
    spec, got = check_mask(bi, label)
    base, n = bi.base, bi.batch.num_rows
    before = chain_mask_kernel.launches
    chain_mask(spec, bi.cols, bi.aux, n, base)
    launches = chain_mask_kernel.launches - before
    if launches != 1:
        raise AssertionError(f"{label}: chain_mask launched {launches} "
                             f"times a call, not once")
    ms = cuda_ms(lambda: chain_mask(spec, bi.cols, bi.aux, n, base), 20)
    plain = cuda_ms(lambda: chain_mask_plain(spec, bi.cols, bi.aux, n,
                                             base), 5)
    d, v = evaluate(spec.pred, bi.cols, bi.aux, n)
    rows = base.rows
    slot_keep = (rows >= 0) & ((d != 0) & v)[rows.clamp(min=0).long()]
    none = torch.full_like(rows, -1)
    floor = cuda_ms(lambda: torch.where(slot_keep, rows, none), 20)
    device = kernel_ms(lambda: chain_mask(spec, bi.cols, bi.aux, n, base),
                       10)
    read = {a for op, a, _b in spec.pred.code if op == OP_COL}
    nbytes = 8 * base.size + col_bytes(bi.cols, read, n)
    bnd = bound(nbytes, n * len(spec.pred.code))
    live = int((got.rows >= 0).sum())
    forms = [None if f is None else f[0] for f, _c in spec.conjuncts]
    print(f"chain_mask {label}: {n} build rows, {base.size} slots, {live} "
          f"kept, conjunct forms {forms}: "
          f"kernel {ms:.6f} ms (the call; profiled device ms {device}), "
          f"plain {plain:.6f} ms, bound "
          f"{bnd['bound_ms']:.6f} ms ({bnd['bytes']} bytes), floor "
          f"(torch.where over the precomputed slot mask) {floor:.6f} ms, "
          f"1 launch a call, max_abs_err 0 [{card}]", flush=True)
    return dict(entry(0.0, ms, plain, bnd, None), floor_ms=floor)


# label -> the walk's launches a run of its query: one a pass of lanes
WALK_LAUNCHES = {}


def chain_walk_vs_plain(ex, tctx, card, label):
    """`chain_aggregate` against its plain version on the chain's staged
    builds and spine (equal group tables, compacted and ordered by key;
    every lane of Q3 and Q5 is an exact decimal sum or a count), its call
    held to one launch a pass of lanes (WALK_LAUNCHES[label], which the
    query's main-path run is held to). The bound is `walk_bytes` and the
    live groups written once. Returns the kernel's report entry."""
    import numpy as np
    import torch
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.groupby import (
        AggregateSpec, compact_groups_plain, dense_group_table)
    from datafusion_tpu_torch.device.join_chain import (
        chain_aggregate, chain_aggregate_plain)
    spec, plan, _names, _slots, inputs, staged = ex.prepare(tctx)
    ((cols, aux, n),) = inputs
    dev = aux.device
    dense = isinstance(spec, AggregateSpec)
    hop_rows = []
    tables = []
    for fold in (chain_aggregate, chain_aggregate_plain):
        table = spec.new_table(dev)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        kw = {"hop_rows": hop_rows} if fold is chain_aggregate_plain else {}
        before = kernels.launch_counts()["chain_aggregate"]
        fold(spec, cols, aux, n, table, overflow,
             dset=spec.distinct_set(n, dev), **kw)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()["chain_aggregate"] - before
        if fold is chain_aggregate and launched != len(spec.metas):
            raise AssertionError(f"{label}: chain_aggregate counted "
                                 f"{launched} launches, not one a pass of "
                                 f"lanes ({len(spec.metas)})")
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
    dset = spec.distinct_set(n, dev)

    def reset():
        scratch.copy_(pristine)
        if dset is not None:
            dset.words.zero_()
    ms = cuda_ms(lambda: chain_aggregate(spec, cols, aux, n, scratch,
                                         overflow, dset), 5, setup=reset)
    plain = cuda_ms(lambda: chain_aggregate_plain(spec, cols, aux, n,
                                                  scratch, overflow,
                                                  dset=dset), 2, setup=reset)
    del scratch, pristine, dset
    nbytes = walk_bytes(spec, cols, n, hop_rows)
    nbytes += got.shape[1] * got.shape[0] * 8    # live groups written once
    bnd = bound(nbytes, prog_ops(spec, n))
    fd = f", keys reduced to {[ex.group_exprs[p][1] for p in plan.kept]}" \
        if plan.dropped else ""
    WALK_LAUNCHES[label] = len(spec.metas)
    print(f"chain_aggregate {label}: {n} spine rows, {len(spec.chain.hops)} "
          f"hops ({routes(spec)}), rows reaching/surviving each hop "
          f"{hop_rows}, {len(spec.metas)} launch(es) a call, "
          f"{'dense' if dense else 'hash'} fold{fd}, {got.shape[1]} groups: "
          f"kernel {ms:.6f} ms, plain {plain:.6f} ms, bound "
          f"{bnd['bound_ms']:.6f} ms ({bnd['bytes']} bytes), max_abs_err 0 "
          f"[{card}]", flush=True)
    return entry(0.0, ms, plain, bnd)


def rows_vs_plain(ex, tctx, card, label):
    """`chain_rows` against its plain version on the row-returning chain
    `ex`'s staged builds and spine (every output column and its validity
    equal, in spine order). The bound is `walk_bytes` and the output
    columns written once. Returns (the kernel's report entry, the rows
    kept)."""
    import torch
    from datafusion_tpu_torch.device.join_chain import (
        _walk_plain, chain_rows, chain_rows_plain)
    from datafusion_tpu_torch import kernels
    spec, inputs, _staged = ex.prepare_rows(tctx)
    ((cols, aux, n, _view),) = inputs
    before = kernels.launch_counts()["chain_rows"]
    got = chain_rows(spec, cols, aux, n)
    launched = kernels.launch_counts()["chain_rows"] - before
    want = chain_rows_plain(spec, cols, aux, n)
    torch.cuda.synchronize()
    for i, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
        if not (torch.equal(gd, wd) and torch.equal(gv, wv)):
            raise AssertionError(f"{label}: chain_rows output {i} differs "
                                 f"from its plain version")
    kept = got[0][0].numel()
    # the walk, and the emit when a row survives
    predicted = 1 + (kept > 0)
    if launched != predicted:
        raise AssertionError(f"{label}: chain_rows counted {launched} "
                             f"launches, not {predicted}")
    ms = cuda_ms(lambda: chain_rows(spec, cols, aux, n), 5)
    plain = cuda_ms(lambda: chain_rows_plain(spec, cols, aux, n), 2)
    hop_rows = []
    _walk_plain(spec, cols, aux, n, hop_rows)
    nbytes = walk_bytes(spec, cols, n, hop_rows)
    nbytes += sum(kept * (d.element_size() + 1) for d, _v in got)
    bnd = bound(nbytes, prog_ops(spec, n))
    print(f"chain_rows {label}: {n} spine rows, {len(spec.chain.hops)} hops "
          f"({routes(spec)}), rows reaching/surviving each hop {hop_rows}, "
          f"{kept} rows kept, {launched} kernel launches and a zero fill "
          f"of the walk's state words a call, "
          f"{len(got)} output columns: kernel {ms:.6f} ms, plain "
          f"{plain:.6f} ms, bound {bnd['bound_ms']:.6f} ms ({bnd['bytes']} "
          f"bytes), max_abs_err 0 [{card}]", flush=True)
    return entry(0.0, ms, plain, bnd), kept


def routes(spec) -> str:
    """How each hop of a walk resolves: probed, composed (into its owner)
    or folded (its records' words)."""
    out = []
    for h, hop in enumerate(spec.chain.hops):
        if hop.compose is not None:
            out.append(f"{h}: composed into {hop.compose.owner}")
        elif hop.fold is not None:
            out.append(f"{h}: folded, {hop.fold.words}-word records")
        else:
            out.append(f"{h}: probed")
    return "; ".join(out)


# what composes or folds at SF10 by the reference's test: supplier's hops
# (nation, region) in Q2, Q5, Q7, Q8, Q9 and Q21; customer's (1.5M rows,
# within 2^22: nation composes into it in Q7, Q8 and Q10, and it folds in
# Q5, Q7, Q8 and Q18); part's (2M rows) folds in Q2 and Q14. Orders (15M
# rows, a span of 60M) neither composes nor folds, so Q3, Q4, Q12 and Q20
# keep their walks.
COMPOSE_SF10 = {2: True, 5: True, 7: True, 8: True, 9: True, 10: True,
                14: True, 18: True, 21: True}


def staging_kernels(ex, tctx, q):
    """Prints which hops the chain exec `ex` of TPC-H query `q` at SF10
    composes (hop: owner, tag) and folds (hop: the reference's span and
    width), and whether that is what COMPOSE_SF10 expects (a difference is
    printed, not raised); returns the staging kernels its run must
    launch."""
    composed, folded = ex.compose_plan(ex.stage_builds(tctx, compose=False))
    said = "as expected" if bool(composed or folded) == \
        COMPOSE_SF10.get(q, False) else "NOT as expected"
    cost = staging_cost(ex, tctx, reps=0)
    want = {"chain_compose": int(bool(composed)),
            "chain_fold": int(bool(folded))}
    if cost["launches"] != want or cost["syncs"] > 1:
        raise AssertionError(f"Q{q} SF10: staging launched "
                             f"{cost['launches']} with {cost['syncs']} "
                             f"synchronisations, not {want} with at most "
                             f"one (one compose and one fold a chain)")
    print(f"Q{q} SF10 staging: composed (hop: owner, tag) {composed}, "
          f"folded (hop: span, width) {folded}, {said}; {cost}", flush=True)
    return ["chain_compose"] * bool(composed) + ["chain_fold"] * bool(folded)


STAGE_REPS = 15
SPAN_REPS = 7
# the spans of a chain's `prepare`: the tables (`dft.build`), the staging
# (`dft.stage`) and its parts (a tree without them reports what it has)
STAGE_SPANS = ("dft.build", "dft.compile", "dft.stage", "dft.stage.plan",
               "dft.stage.stats", "dft.stage.spec", "dft.stage.launch",
               "dft.stage.upload")


def stage_call(ex, tctx):
    """A call that stages the chain exec `ex`'s compositions and folds as
    its tree does, from tables staged once (`stage_builds(compose=False)`),
    and returns when the card has finished: in a tree that stages them in
    `chain` (its `compose` argument), `chain` alone; in one that composes
    in `compose_builds` and folds in `chain`, both. `chain` gets the same
    programs in both trees: the probe predicate and the min/max tests,
    and as `reads` the residual with the outputs (a row chain) or with
    every group key and lane argument (an aggregate chain, before the
    functional-dependence reduction). Each call empties the session's
    chain caches and the stats kept with the staged builds first, so it
    stages as a cold query does."""
    import inspect
    import torch
    if hasattr(ex, "lower_rows"):
        pools, ppred, pred, outs, probe_keys, mfilters = ex.lower_rows()
        reads = [pred] + outs
    else:
        (pools, ppred, pred, keys, slot_defs, _slot_map, probe_keys,
         mfilters) = ex.lower()
        reads = [pred] + keys + [p for _c, p in slot_defs.values()]
    staged = ex.stage_builds(tctx, compose=False)
    torch.cuda.synchronize()
    args = (ppred, staged, probe_keys, mfilters, pools, reads)
    if "compose" in inspect.signature(ex.chain).parameters:
        def call():
            clear_chain_caches(ex, staged)
            ex.chain(*args, True)
            torch.cuda.synchronize()
    else:
        def call():
            ex.compose_builds(staged)
            ex.chain(*args)
            torch.cuda.synchronize()
    return call


def staging_cost(ex, tctx, reps=STAGE_REPS):
    """What staging costs the chain exec `ex` of a tree: the
    `chain_compose` and `chain_fold` launches and the synchronising CUDA
    calls (torch's sync debug mode) that composition and folding add to
    one `prepare` (or `prepare_rows`). With `reps`, also the chain's
    staging alone (`stage_call`) on one yardstick for every tree: its host
    wall ms through the card's finish over `reps` runs after a warm-up
    (`wall_ms`: median, least, most) and the device ms of its
    `chain_compose` and `chain_fold` kernels in one profiled run
    (`device_ms`); and the host ms of each span of STAGE_SPANS in
    SPAN_REPS profiled runs of `prepare` with composition and folding,
    each run ending in a synchronisation (`spans_ms`: median, least, most
    of a run's total of the span; the tables' `chain_build` sits in
    `dft.build`), with the device ms of `chain_build`, `chain_compose` and
    `chain_fold` in the last of those runs (`spans_device_ms`). Every
    staging here starts from emptied chain caches (`clear_chain_caches`),
    as a cold query's does."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    from datafusion_tpu_torch import kernels
    prep = ex.prepare_rows if hasattr(ex, "prepare_rows") else ex.prepare

    def syncs(compose):
        clear_chain_caches(ex)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                prep(tctx, compose)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum(str(w.message).startswith("called a synchronizing")
                   for w in seen)

    def spread(xs):
        return [statistics.median(xs), min(xs), max(xs)]

    def staging_device_ms(by_kernel):
        return {k: round(sum(v for key, v in by_kernel.items()
                             if k in key and "_kernel" in key), 4)
                for k in ("chain_build", "chain_compose", "chain_fold")}
    names = ("chain_compose", "chain_fold")
    before = {k: kernels.launch_counts()[k] for k in names}
    clear_chain_caches(ex)
    prep(tctx, True)
    launches = {k: kernels.launch_counts()[k] - before[k] for k in names}
    out = {"launches": launches, "syncs": syncs(True) - syncs(False)}
    if reps:
        call = stage_call(ex, tctx)
        call()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        out["wall_ms"] = spread(times)
        dev_ms = staging_device_ms(kernel_ms(call))
        out["device_ms"] = {k: dev_ms[k] for k in names}
        runs = []
        for i in range(SPAN_REPS):
            acts = [ProfilerActivity.CPU] + \
                [ProfilerActivity.CUDA] * (i == SPAN_REPS - 1)
            clear_chain_caches(ex)
            with profile(activities=acts) as prof:
                prep(tctx, True)
                torch.cuda.synchronize()
            evs = prof.key_averages()
            runs.append({ev.key: ev.cpu_time_total / 1e3 for ev in evs
                         if ev.key in STAGE_SPANS})
        out["spans_ms"] = {k: spread([r[k] for r in runs])
                           for k in STAGE_SPANS if k in runs[-1]}
        by_kernel = {}
        for ev in evs:
            if getattr(ev, "self_device_time_total", 0):
                by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + \
                    ev.self_device_time_total / 1e3
        out["spans_device_ms"] = staging_device_ms(by_kernel)
    torch.cuda.empty_cache()
    return out


def compose_vs_plain(ex, tctx, card, label):
    """`chain_compose` and `chain_fold` against their plain versions on the
    chain exec `ex`'s staged builds: the chain's staging (`stage_spec`,
    every payload column of a folded hop held) into fresh outputs through
    the kernels (one descriptor, one launch each) and through
    `chain_stage_plain`, all exact. The bound of the compositions is the
    owners' key columns and the composed hops' tables read once and the
    words written once; of the folds the tables' rows, the owners'
    composed words and the payload columns read once and the records
    written once. Each kernel is timed alone on the uploaded descriptor
    (its `ms`); the wrapper, `chain_stage` (the descriptor's upload and
    both launches), is timed too and printed beside it; a kernel's plain
    time is `chain_stage_plain` of that half. Returns (the compose entry,
    the fold entry)."""
    import copy
    import torch
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.groupby import _stream
    from datafusion_tpu_torch.device.join_chain import (
        chain_stage, chain_stage_plain, new_stage_outputs, upload)
    staged = ex.stage_builds(tctx)
    spec, cols, aux = ex.stage_spec(staged)
    dev = aux.device
    got_w, got_f = new_stage_outputs(spec, dev)
    for t in list(got_w.values()) + [t for f in got_f for t in f
                                     if t is not None]:
        t.fill_(-7 if t.dtype == torch.int64 else 0x5A)
    names = ("chain_compose", "chain_fold")
    before = {k: kernels.launch_counts()[k] for k in names}
    chain_stage(spec, cols, aux, got_w, got_f)
    launched = {k: kernels.launch_counts()[k] - before[k] for k in names}
    want_w, want_f = new_stage_outputs(spec, dev)
    chain_stage_plain(spec, cols, aux, want_w, want_f)
    torch.cuda.synchronize()
    if launched != {"chain_compose": int(bool(spec.composed)),
                    "chain_fold": int(bool(spec.folds))}:
        raise AssertionError(f"{label}: staging launched {launched}")
    if not all(torch.equal(got_w[o], want_w[o]) for o in want_w) or \
            not all(a is b or torch.equal(a, b)
                    for fa, fb in zip(got_f, want_f)
                    for a, b in zip(fa, fb)):
        raise AssertionError(f"{label}: chain_compose or chain_fold differs "
                             f"from its plain version")
    for s in staged:
        c = s.compose
        if c is not None and not torch.equal(c.words, got_w[c.owner]):
            raise AssertionError(f"{label}: the staged words differ")
    lib = kernels.library()
    wrapper = cuda_ms(lambda: chain_stage(spec, cols, aux, got_w, got_f), 20)
    desc = upload(spec.host_words(cols, got_w, got_f), dev)
    stream = _stream(dev)
    ent_c = ent_f = None
    if spec.composed:
        halves = copy.copy(spec)
        halves.folds = []
        ms = cuda_ms(lambda: kernels.check(lib.dft_chain_compose(
            desc.data_ptr(), len(spec.meta), aux.data_ptr(),
            spec.compose_threads, int(spec.full), stream),
            kernels.KERNELS["chain_compose"]), 20)
        plain = cuda_ms(lambda: chain_stage_plain(halves, cols, aux, want_w,
                                                  []), 3)
        nbytes = col_bytes(cols, spec.pools.columns, spec.compose_threads) + \
            sum(spec.chain.hops[h].table.size *
                entry_bytes(spec.chain.hops[h].table)
                for h in spec.composed) + \
            sum(w.numel() * 8 for w in got_w.values())
        bnd = bound(nbytes, prog_ops(spec, spec.compose_threads))
        print(f"chain_compose {label}: hops {dict(spec.composed)} (hop: "
              f"owner, word, tag) into {spec.rows} owner rows, one launch: "
              f"kernel {ms:.6f} ms (the wrapper with the fold "
              f"{wrapper:.6f}), plain {plain:.6f} ms, bound "
              f"{bnd['bound_ms']:.6f} ms, max_abs_err 0 [{card}]",
              flush=True)
        ent_c = entry(0.0, ms, plain, bnd)
    if spec.folds:
        halves = copy.copy(spec)
        halves.composed = {}
        ms = cuda_ms(lambda: kernels.check(lib.dft_chain_fold(
            desc.data_ptr() + 8 * len(spec.meta), spec.fold_threads,
            stream), kernels.KERNELS["chain_fold"]), 20)
        plain = cuda_ms(lambda: chain_stage_plain(halves, cols, aux, got_w,
                                                  want_f), 3)
        nbytes = 0
        for (h, t, f), (rec, valid) in zip(spec.folds, got_f):
            rows = staged[h].batch.num_rows
            comp = got_w.get(h)
            nbytes += t.size * 4 + rec.numel() * 8 + \
                (0 if valid is None else valid.numel()) + \
                (0 if comp is None else comp.numel() * 8) + \
                sum(rows * (cols[i][0].element_size() +
                            (cols[i][1] is not None)) for i in f.columns)
        bnd = bound(nbytes, 0)
        shapes = [(h, t.size, f.words, f.n_comp, len(f.columns))
                  for h, t, f in spec.folds]
        print(f"chain_fold {label}: folds (hop, slots, record words, "
              f"composed, payload columns) {shapes}, one launch: kernel "
              f"{ms:.6f} ms (the wrapper with the compositions "
              f"{wrapper:.6f}), plain {plain:.6f} ms, bound "
              f"{bnd['bound_ms']:.6f} ms, max_abs_err 0 [{card}]",
              flush=True)
        ent_f = entry(0.0, ms, plain, bnd)
    del desc, got_w, got_f, want_w, want_f
    return ent_c, ent_f


def emit_vs_plain(ctx, sql, card, label):
    """`group_emit_columns` against its plain version on the compacted
    group table of the query's large aggregate (every column and its
    validity equal). The bound counts each row of the table that a field
    reads once and each output written once. Returns (the kernel's report
    entry, the groups)."""
    import torch
    from datafusion_tpu_torch.device.groupby import (
        EMIT_SUM, compact_groups, group_emit_columns,
        group_emit_columns_plain)
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        RESIDENT_EMIT_MIN_GROUPS, TorchGroupAggregateExec)
    ex = find_exec(ctx.sql(sql).create_physical_plan(),
                   TorchGroupAggregateExec)
    batches = ex.input_batches(ctx.task_context())
    spec, plan, names, slot_map = ex.compile(batches)
    groups = compact_groups(ex.group_table(spec, batches, True))
    ng = groups.shape[1]
    if ng < RESIDENT_EMIT_MIN_GROUPS or not ex._emit_device_ok(plan):
        raise AssertionError(f"{label}: {ng} groups do not stay on the card")
    fields = ex.emit_fields(plan, names, slot_map)
    got = group_emit_columns(groups, fields)
    want = group_emit_columns_plain(groups, fields)
    torch.cuda.synchronize()
    for i, ((gd, gv), (wd, wv)) in enumerate(zip(got, want)):
        if not (torch.equal(gd, wd) and (gv is None) == (wv is None) and
                (gv is None or torch.equal(gv, wv))):
            raise AssertionError(f"{label}: group_emit column {i} differs")
    ms = cuda_ms(lambda: group_emit_columns(groups, fields), 10)
    plain = cuda_ms(lambda: group_emit_columns_plain(groups, fields), 3)
    rows = {f.row for f in fields} | {f.count_row for f in fields
                                      if f.kind == EMIT_SUM}
    nbytes = ng * (8 * len(rows) + sum(
        d.element_size() + (v is not None) for d, v in got))
    bnd = bound(nbytes, ng * len(fields))
    device = sum(v for k, v in kernel_ms(
        lambda: group_emit_columns(groups, fields), 10).items()
        if "emit" in k)
    print(f"group_emit {label}: {ng} groups, {len(fields)} columns: kernel "
          f"{ms:.6f} ms (events, the call), {device:.6f} ms (device, "
          f"profiled, mean of 10: {bnd['bound_ms'] / max(device, 1e-9):.3f} "
          f"of the bound's rate), plain {plain:.6f} ms, bound "
          f"{bnd['bound_ms']:.6f} ms ({bnd['bytes']} bytes), max_abs_err 0 "
          f"[{card}]", flush=True)
    return entry(0.0, ms, plain, bnd), ng


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


def radix_vs_plain(words, dev, card, label, library=False, predicted=True):
    """`radix_sort` against its plain version on the order words (equal
    permutations, and np.lexsort's order), both timed; with `library` a
    stable `torch.sort` of the first uint64 word (as int64 order) as the
    yardstick; with `predicted` its launches a sort held to
    `sort_launch_count`. The bound counts each word read once and the
    permutation written once. Returns (the kernel's report entry, its
    permutation, its launches)."""
    import torch
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.physical.plan.device_sort import (
        radix_sort, radix_sort_plain, to_word)
    staged = [to_word(w).to(dev) for w in words]
    n = len(words[0])
    before = kernels.launch_counts()["radix_sort"]
    got = radix_sort(staged)
    launches = kernels.launch_counts()["radix_sort"] - before
    if predicted:
        from datafusion_tpu_torch.physical.plan.device_sort import (
            sort_launch_count)
        if launches != sort_launch_count(words):
            raise AssertionError(f"{label}: radix_sort counted {launches} "
                                 f"launches, not {sort_launch_count(words)}")
    want = radix_sort_plain(staged)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: radix_sort differs from its plain "
                             f"version")
    if not lexsort_order_holds(staged, got):
        raise AssertionError(f"{label}: radix_sort differs from np.lexsort")
    del want
    ms = cuda_ms(lambda: radix_sort(staged), 5)
    plain = cuda_ms(lambda: radix_sort_plain(staged), 2)
    lib = None
    if library:
        key = next(w for w in staged if w.dtype == torch.int64) ^ (-2**63)
        lib = cuda_ms(lambda: torch.sort(key, stable=True), 5)
        del key
    bnd = bound(sum(n * w.dtype.itemsize for w in words) + n * 8,
                n * len(words))
    print(f"radix_sort {label}: {n} rows, {len(words)} words, {launches} "
          f"launches a sort: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
          f"torch.sort {lib} ms, bound {bnd['bound_ms']:.6f} ms, "
          f"max_abs_err 0 [{card}]", flush=True)
    return entry(0.0, ms, plain, bnd, lib), got.cpu().numpy(), launches


def lexsort_order_holds(words, perm) -> bool:
    """Whether `perm` (on the card) is the permutation
    `np.lexsort(tuple(reversed(words)))` returns for these order words
    (uint8, or int64 holding uint64 bits): every row once, the words in
    ascending lexicographic order along it (compared unsigned), ties in
    row order. The stable ascending order is unique, so this is equality
    with np.lexsort, checked on the card in a pass a word."""
    import torch
    n = perm.numel()
    if n and (int(perm.min()) < 0 or int(perm.max()) >= n):
        return False
    seen = torch.zeros(n, dtype=torch.bool, device=perm.device)
    seen[perm] = True
    if not bool(seen.all()):
        return False
    lt = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=perm.device)
    eq = torch.ones_like(lt)
    for w in words:
        x = w[perm]
        if x.dtype == torch.int64:
            x = x ^ (-2**63)         # unsigned order as signed
        lt |= eq & (x[:-1] < x[1:])
        eq &= x[:-1] == x[1:]
    return bool((lt | (eq & (perm[:-1] < perm[1:]))).all())


def oracle_first(keys, k=10):
    """Row indices of the first k rows in the stable order of `keys` (most
    significant first): the candidates at or below the k-th smallest first
    key, ordered by np.lexsort."""
    import numpy as np
    kth = np.partition(keys[0], k - 1)[k - 1]
    cand = np.flatnonzero(keys[0] <= kth)
    return cand[np.lexsort(tuple(x[cand] for x in reversed(keys)))[:k]]


def window_batches(ctx, sql, all_runs=False):
    """(exec, batches, runs) of the query's WindowExec as the main path
    evaluates it: its whole input, or for a BoundedWindowExec the first
    of its `runs` partition runs (every run, in order, with
    `all_runs`)."""
    import numpy as np
    from datafusion_tpu_torch.physical.plan.base import collect_batch
    from datafusion_tpu_torch.physical.plan.window import (
        BoundedWindowExec, WindowExec)
    ex = find_exec(ctx.sql(sql).create_physical_plan(), WindowExec)
    batch = collect_batch(ex.input, ctx.task_context())
    if not isinstance(ex, BoundedWindowExec):
        return ex, [batch], 1
    key = ex.window_exprs[0].partition_by[0].evaluate(batch).data_host()
    cuts = [0, *(np.flatnonzero(key[1:] != key[:-1]) + 1), batch.num_rows]
    runs = [batch.take_host(np.arange(a, b))
            for a, b in zip(cuts, cuts[1:] if all_runs else cuts[1:2])]
    return ex, runs, len(cuts) - 1


def window_kernels_vs_plain(ctx, sql, card, label):
    """For each window function of the query's WindowExec, on the inputs
    of one evaluation of the main path (a BoundedWindowExec's first
    partition run): `radix_sort`, `gather_lanes` and `window_scan` against
    their plain versions (equal, all of them: W1-W3 sum only decimals).
    Bounds: the gather reads the index once and each lane once and writes
    each lane once; the scan reads the sorted words, lanes and the
    permutation once and writes each output once; the scan's yardstick
    is a floor, `index_copy_` of one int64 lane through the permutation
    (the scatter every design pays; no one PyTorch call computes a window
    function). Returns the report entries (gather, scan) of the first
    function, the gather's launches that `gather_plan` predicts for one
    batch's evaluations and the scan's that `scan_launches` predicts for
    one run of the query (every partition run), each of which is held to
    its prediction."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        gather_lanes_kernel, gather_plan, reorder_rows, reorder_rows_plain)
    from datafusion_tpu_torch.device.window import (
        scan_launches, stage_window, window_scan, window_scan_kernel,
        window_scan_plain)
    from datafusion_tpu_torch.physical.plan.device_sort import (
        radix_sort, radix_sort_plain)
    from datafusion_tpu_torch.physical.plan.window import (
        _plan_window_evaluation, device_window_inputs)
    ex, (batch,), n_runs = window_batches(ctx, sql)
    n, first, predicted, scans = batch.num_rows, None, 0, 0
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
        if not torch.equal(perm, radix_sort_plain(words)) or \
                not lexsort_order_holds(words, perm):
            raise AssertionError(f"{label} {spec}: radix_sort differs")
        extras = [x for x in lanes if x is not None]
        plan = gather_plan([t.element_size() for t in words + extras], n, n)
        before = gather_lanes_kernel.launches
        moved = reorder_rows(perm, words + extras)
        launches = gather_lanes_kernel.launches - before
        predicted += sum(g.launches for g in plan)
        if launches != sum(g.launches for g in plan):
            raise AssertionError(f"{label} {spec}: gather_lanes counted "
                                 f"{launches} launches, not as its plan")
        for g, p in zip(moved, reorder_rows_plain(perm, words + extras)):
            if not torch.equal(g, p):
                raise AssertionError(f"{label} {spec}: gather_lanes differs")
        sw, rest = moved[:len(words)], iter(moved[len(words):])
        sl = [None if x is None else next(rest) for x in lanes]
        before = window_scan_kernel.launches
        got = window_scan(sw, len(pw), perm, spec, *sl)
        launches_s = window_scan_kernel.launches - before
        if launches_s != scan_launches(spec):
            raise AssertionError(f"{label} {spec}: window_scan counted "
                                 f"{launches_s} launches, not "
                                 f"{scan_launches(spec)}")
        scans += scan_launches(spec) * n_runs
        want = window_scan_plain(sw, len(pw), perm, spec, *sl)
        torch.cuda.synchronize()
        for k in want:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"{label} {spec}: window_scan's {k} "
                                     f"differs")
        del want
        ms_g = cuda_ms(lambda: reorder_rows(perm, words + extras), 5)
        plain_g = cuda_ms(lambda: reorder_rows_plain(perm, words + extras), 2)
        # one PyTorch call a lane: index_select
        lib_g = cuda_ms(lambda: [t.index_select(0, perm)
                                 for t in words + extras], 5)
        width = sum(t.element_size() for t in words + extras)
        b_g = bound(n * 8 + 2 * n * width, 0)
        ms_s = cuda_ms(lambda: window_scan(sw, len(pw), perm, spec, *sl), 5)
        plain_s = cuda_ms(
            lambda: window_scan_plain(sw, len(pw), perm, spec, *sl), 2)
        lane, into = (torch.zeros(n, dtype=torch.int64, device=perm.device)
                      for _ in range(2))
        floor_s = cuda_ms(lambda: into.index_copy_(0, perm, lane), 5)
        del lane, into
        read = n * (8 + sum(t.element_size() for t in sw) +
                    sum(t.element_size() for t in sl if t is not None))
        wrote = sum(v.numel() * v.element_size() for v in got.values())
        b_s = bound(read + wrote, n)
        layout = ", ".join(f"{g.w} B in {g.width} "
                           f"{'packed' if g.packed else 'direct'}"
                           for g in plan)
        print(f"{label} {spec}: {n} rows, {len(words)} words, {len(extras)} "
              f"lanes ({layout}, {launches} launches); gather_lanes kernel "
              f"{ms_g:.6f} ms, plain "
              f"{plain_g:.6f} ms, index_select {lib_g:.6f} ms, bound "
              f"{b_g['bound_ms']:.6f} ms; "
              f"window_scan kernel {ms_s:.6f} ms ({launches_s} launches), "
              f"plain {plain_s:.6f} ms, bound {b_s['bound_ms']:.6f} ms, "
              f"floor (index_copy_ of one int64 lane) {floor_s:.6f} ms; "
              f"every output equal [{card}]", flush=True)
        if first is None:
            first = (entry(0.0, ms_g, plain_g, b_g, lib_g),
                     entry(0.0, ms_s, plain_s, b_s, floor_s))
        del words, lanes, extras, perm, moved, sw, sl, got
        torch.cuda.empty_cache()
    return first, predicted, scans


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

def oracle_q3(t, segment="BUILDING"):
    """(l_orderkey, revenue at scale 4, o_orderdate) of Q3's top 10, of
    the customers of market segment `segment` (Q3's BUILDING unless
    given)."""
    import numpy as np
    cust, orders, li = t["customer"], t["orders"], t["lineitem"]
    seg = cust.column_by_name("c_mktsegment")
    building = col(cust, "c_mktsegment") == seg.dictionary.lookup(segment)
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


def oracle_q5(t, year=1994, region_name="ASIA"):
    """Q5's (nation name, revenue at scale 4), by revenue descending, of
    the orders of `year` in the region `region_name` (Q5's 1994 and ASIA
    unless given)."""
    import numpy as np
    cust, orders, li = t["customer"], t["orders"], t["lineitem"]
    nation, region, supp = t["nation"], t["region"], t["supplier"]
    asia = region.column_by_name("r_name").dictionary.lookup(region_name)
    r_asia = col(region, "r_regionkey")[col(region, "r_name") == asia]
    n_in = np.isin(col(nation, "n_regionkey"), r_asia)
    o_date = col(orders, "o_orderdate")
    o_ok = (o_date >= days(year, 1, 1)) & (o_date < days(year + 1, 1, 1))
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


def oracle_q2(t):
    """Q2's 100 rows as {column: values}: EUROPE's suppliers of each part
    of size 15 and a BRASS type at the part's least EUROPE cost, by
    balance descending, nation, supplier and part."""
    import numpy as np
    supp, nation, region = t["supplier"], t["nation"], t["region"]
    part, ps = t["part"], t["partsupp"]
    europe = region.column_by_name("r_name").dictionary.lookup("EUROPE")
    eu = np.isin(col(nation, "n_regionkey"),
                 col(region, "r_regionkey")[col(region, "r_name") == europe])
    s_nat = col(supp, "s_nationkey")
    ps_p, ps_s = col(ps, "ps_partkey"), col(ps, "ps_suppkey")
    cost = col(ps, "ps_supplycost")
    m = eu[s_nat[ps_s - 1]]
    least = np.full(part.num_rows + 1, np.iinfo(np.int64).max)
    np.minimum.at(least, ps_p[m], cost[m])
    types = part.column_by_name("p_type").dictionary.values
    brass = np.array([str(v).endswith("BRASS") for v in types])
    p_ok = (col(part, "p_size") == 15) & brass[col(part, "p_type")]
    sel = np.flatnonzero(m & p_ok[ps_p - 1] & (cost == least[ps_p]))
    s = ps_s[sel] - 1
    out = {"s_acctbal": col(supp, "s_acctbal")[s],
           "s_name": col(supp, "s_name")[s],
           "n_name": col(nation, "n_name")[s_nat[s]],
           "p_partkey": ps_p[sel],
           "p_mfgr": col(part, "p_mfgr")[ps_p[sel] - 1],
           "s_address": col(supp, "s_address")[s],
           "s_phone": col(supp, "s_phone")[s],
           "s_comment": col(supp, "s_comment")[s]}
    # dictionary codes sort as their strings
    order = np.lexsort((out["p_partkey"], out["s_name"], out["n_name"],
                        -out["s_acctbal"]))[:100]
    owner = {"n_name": nation, "p_mfgr": part, "s_name": supp,
             "s_address": supp, "s_phone": supp, "s_comment": supp}
    rows = {}
    for c, v in out.items():
        rows[c] = v[order].tolist() if c not in owner else \
            list(owner[c].column_by_name(c).dictionary.values[v[order]])
    return rows, len(sel)


def oracle_q20(t):
    """Q20's (s_name, s_address) of CANADA's suppliers that stock a
    'forest' part above half the quantity they shipped of it in 1994, by
    name; and the number of (part, supplier) groups shipped in 1994."""
    import numpy as np
    supp, nation, part, ps, li = (t[k] for k in (
        "supplier", "nation", "part", "partsupp", "lineitem"))
    names = part.column_by_name("p_name").dictionary.values
    forest = np.r_[False, np.array([str(v).startswith("forest")
                                    for v in names])[col(part, "p_name")]]
    ship = col(li, "l_shipdate")
    m = (ship >= days(1994, 1, 1)) & (ship < days(1995, 1, 1))
    width = supp.num_rows + 1
    key = col(li, "l_partkey")[m] * width + col(li, "l_suppkey")[m]
    uk, inv = np.unique(key, return_inverse=True)
    qty = np.bincount(inv, weights=col(li, "l_quantity")[m]).astype(np.int64)
    ps_p, ps_s = col(ps, "ps_partkey"), col(ps, "ps_suppkey")
    pos = np.minimum(np.searchsorted(uk, ps_p * width + ps_s), len(uk) - 1)
    # availqty > 0.5 * sum(quantity), the quantity at scale 2
    ok = (uk[pos] == ps_p * width + ps_s) & forest[ps_p] & \
        (qty[pos] < 200 * col(ps, "ps_availqty").astype(np.int64))
    canada = nation.column_by_name("n_name").dictionary.lookup("CANADA")
    c_key = col(nation, "n_nationkey")[col(nation, "n_name") == canada]
    s = np.unique(ps_s[ok]) - 1
    s = s[np.isin(col(supp, "s_nationkey")[s], c_key)]
    s = s[np.argsort(col(supp, "s_name")[s], kind="stable")]
    dic = {c: supp.column_by_name(c).dictionary for c in ("s_name",
                                                        "s_address")}
    return ({c: list(dic[c].values[col(supp, c)[s]]) for c in dic},
            len(uk))


def year_of(d):
    """The calendar year of Date32 days."""
    import numpy as np
    return d.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970


def names_of(batch, column):
    """Each row's string of a dictionary column, as an object array."""
    c = batch.column_by_name(column)
    return c.dictionary.values[c.data_host()]


def code_of(batch, column, value):
    return batch.column_by_name(column).dictionary.lookup(value)


def line_keys(t):
    """Per lineitem row: the row of its order, of its supplier, of its part
    and of its partsupp entry (keys are dense: o_orderkey = 4i - 3, the
    supplier of a line is one of its part's 4, `tpch_tables`)."""
    li, supp = t["lineitem"], t["supplier"]
    n_supp = supp.num_rows
    part = col(li, "l_partkey") - 1
    sk = col(li, "l_suppkey") - 1
    which = ((sk - part) % n_supp) // (n_supp // 4 + 1)
    return (col(li, "l_orderkey") + 3) // 4 - 1, sk, part, part * 4 + which


def revenue(li, m):
    """l_extendedprice * (1 - l_discount) of the rows `m`, at scale 4."""
    return col(li, "l_extendedprice")[m] * (100 - col(li, "l_discount")[m])


def group_sums(keys, values):
    """(distinct key tuples, sum of `values` over each), ordered by key."""
    import numpy as np
    uk, inv = np.unique(np.stack(keys, 1), axis=0, return_inverse=True)
    sums = np.zeros(len(uk), np.int64)
    np.add.at(sums, inv.ravel(), values)
    return uk, sums


def oracle_q7(t):
    """Q7's rows: (supplier nation, customer nation, ship year, revenue) of
    FRANCE and GERMANY trade in 1995-1996, in that order."""
    import numpy as np
    li, nation = t["lineitem"], t["nation"]
    oi, si, _p, _ps = line_keys(t)
    s_nat = col(t["supplier"], "s_nationkey")[si]
    c_nat = col(t["customer"], "c_nationkey")[
        col(t["orders"], "o_custkey")[oi] - 1]
    fr, de = (col(nation, "n_nationkey")[col(nation, "n_name") ==
                                         code_of(nation, "n_name", n)][0]
              for n in ("FRANCE", "GERMANY"))
    ship = col(li, "l_shipdate")
    m = (((s_nat == fr) & (c_nat == de)) | ((s_nat == de) & (c_nat == fr))) \
        & (ship >= days(1995, 1, 1)) & (ship <= days(1996, 12, 31))
    names = names_of(nation, "n_name")
    keys, sums = group_sums([s_nat[m], c_nat[m], year_of(ship[m])],
                            revenue(li, m))
    rows = sorted(zip(names[keys[:, 0]], names[keys[:, 1]], keys[:, 2],
                      sums.tolist()))
    return [(a, b, float(y), v) for a, b, y, v in rows]


def oracle_q8(t):
    """Q8's (order year, BRAZIL's share at scale 8, truncated as a decimal
    division) of AMERICA's ECONOMY ANODIZED STEEL orders of 1995-1996."""
    import numpy as np
    li, nation, region = t["lineitem"], t["nation"], t["region"]
    oi, si, pi, _ps = line_keys(t)
    america = col(region, "r_regionkey")[
        col(region, "r_name") == code_of(region, "r_name", "AMERICA")]
    c_nat = col(t["customer"], "c_nationkey")[
        col(t["orders"], "o_custkey")[oi] - 1]
    o_date = col(t["orders"], "o_orderdate")[oi]
    steel = col(t["part"], "p_type")[pi] == code_of(
        t["part"], "p_type", "ECONOMY ANODIZED STEEL")
    m = np.isin(col(nation, "n_regionkey")[c_nat], america) & steel & \
        (o_date >= days(1995, 1, 1)) & (o_date <= days(1996, 12, 31))
    brazil = col(nation, "n_nationkey")[col(nation, "n_name") == code_of(
        nation, "n_name", "BRAZIL")][0]
    vol = revenue(li, m)
    years = year_of(o_date[m])
    s_nat = col(t["supplier"], "s_nationkey")[si[m]]
    out = []
    for y in np.unique(years):
        tot = int(vol[years == y].sum())
        br = int(vol[(years == y) & (s_nat == brazil)].sum())
        out.append((float(y), br * 10**8 // tot))
    return out


def oracle_q9(t):
    """Q9's (nation, order year, profit at scale 4) of the green parts, by
    nation and year descending."""
    import numpy as np
    li, part, nation = t["lineitem"], t["part"], t["nation"]
    oi, si, pi, psi = line_keys(t)
    names = part.column_by_name("p_name").dictionary.values
    green = np.array(["green" in str(v) for v in names])
    m = green[col(part, "p_name")[pi]]
    amount = revenue(li, m) - col(t["partsupp"], "ps_supplycost")[psi[m]] * \
        col(li, "l_quantity")[m]
    s_nat = col(t["supplier"], "s_nationkey")[si[m]]
    years = year_of(col(t["orders"], "o_orderdate")[oi[m]])
    keys, sums = group_sums([s_nat, years], amount)
    n_names = names_of(nation, "n_name")
    rows = sorted(zip(n_names[keys[:, 0]], -keys[:, 1], sums.tolist()))
    return [(n, float(-y), v) for n, y, v in rows]


def oracle_q10(t):
    """Q10's 20 customers with the most revenue of returned lines ordered
    in 1993 Q4: (custkey, name, revenue at scale 4, balance, nation,
    address, phone, comment)."""
    import numpy as np
    li, cust, orders = t["lineitem"], t["customer"], t["orders"]
    oi, _s, _p, _ps = line_keys(t)
    o_date = col(orders, "o_orderdate")[oi]
    m = (col(li, "l_returnflag") == code_of(li, "l_returnflag", "R")) & \
        (o_date >= days(1993, 10, 1)) & (o_date < days(1994, 1, 1))
    ci = col(orders, "o_custkey")[oi[m]] - 1
    rev = np.zeros(cust.num_rows, np.int64)
    np.add.at(rev, ci, revenue(li, m))
    has = np.zeros(cust.num_rows, bool)
    has[ci] = True
    top = np.flatnonzero(has)[np.argsort(-rev[has], kind="stable")[:20]]
    n_names = names_of(t["nation"], "n_name")
    return [(int(col(cust, "c_custkey")[c]), names_of(cust, "c_name")[c],
             int(rev[c]), int(col(cust, "c_acctbal")[c]),
             n_names[col(cust, "c_nationkey")[c]],
             names_of(cust, "c_address")[c], names_of(cust, "c_phone")[c],
             names_of(cust, "c_comment")[c]) for c in top], int(has.sum())


def oracle_q12(t):
    """Q12's (ship mode, high priority lines, low priority lines)."""
    import numpy as np
    li, orders = t["lineitem"], t["orders"]
    oi, _s, _p, _ps = line_keys(t)
    ship, commit, receipt = (col(li, c) for c in (
        "l_shipdate", "l_commitdate", "l_receiptdate"))
    modes = [code_of(li, "l_shipmode", x) for x in ("MAIL", "SHIP")]
    m = np.isin(col(li, "l_shipmode"), modes) & (commit < receipt) & \
        (ship < commit) & (receipt >= days(1994, 1, 1)) & \
        (receipt < days(1995, 1, 1))
    prio = col(orders, "o_orderpriority")[oi[m]]
    high = np.isin(prio, [code_of(orders, "o_orderpriority", x)
                          for x in ("1-URGENT", "2-HIGH")])
    mode = col(li, "l_shipmode")[m]
    names = names_of(li, "l_shipmode")
    return sorted((li.column_by_name("l_shipmode").dictionary.values[c],
                   int((high & (mode == c)).sum()),
                   int((~high & (mode == c)).sum()))
                  for c in np.unique(mode)) if len(names) else []


def oracle_q14(t):
    """Q14's promo revenue share of September 1995, as the host computes
    100.00 * sum(promo) / sum(all) in float64 over the decimal sums."""
    import numpy as np
    li, part = t["lineitem"], t["part"]
    _o, _s, pi, _ps = line_keys(t)
    ship = col(li, "l_shipdate")
    m = (ship >= days(1995, 9, 1)) & (ship < days(1995, 10, 1))
    types = part.column_by_name("p_type").dictionary.values
    promo = np.array([str(v).startswith("PROMO") for v in types])[
        col(part, "p_type")[pi[m]]]
    vol = revenue(li, m)
    return int(vol[promo].sum()), int(vol.sum())


def oracle_q18(t):
    """Q18's 100 large orders: (name, custkey, orderkey, date, total price,
    quantity), by total price descending and date."""
    import numpy as np
    li, cust, orders = t["lineitem"], t["customer"], t["orders"]
    oi, _s, _p, _ps = line_keys(t)
    qty = np.bincount(oi, weights=col(li, "l_quantity"),
                      minlength=orders.num_rows).astype(np.int64)
    big = np.flatnonzero(qty > 300 * 100)
    price, date = col(orders, "o_totalprice"), col(orders, "o_orderdate")
    top = big[np.lexsort((date[big], -price[big]))[:100]]
    ci = col(orders, "o_custkey")[top] - 1
    return [(names_of(cust, "c_name")[c], int(c + 1),
             int(col(orders, "o_orderkey")[o]), int(date[o]), int(price[o]),
             int(qty[o])) for o, c in zip(top, ci)], len(big)


def oracle_q21(t):
    """Q21's (supplier name, waiting lines) of SAUDI ARABIA, by count
    descending and name: late lines of status-F orders where another
    supplier also has a line and no other supplier's line is late, found
    by comparing each line with the up to 6 others of its order (lines of
    an order are adjacent)."""
    import numpy as np
    li, supp, orders, nation = (t[k] for k in (
        "lineitem", "supplier", "orders", "nation"))
    oi, si, _p, _ps = line_keys(t)
    late = col(li, "l_receiptdate") > col(li, "l_commitdate")
    n = li.num_rows
    other = np.zeros(n, bool)
    other_late = np.zeros(n, bool)
    for d in range(1, 7):
        for a, b in ((slice(d, None), slice(None, n - d)),
                     (slice(None, n - d), slice(d, None))):
            differ = (oi[a] == oi[b]) & (si[a] != si[b])
            other[a] |= differ
            other_late[a] |= differ & late[b]
    saudi = col(nation, "n_nationkey")[col(nation, "n_name") == code_of(
        nation, "n_name", "SAUDI ARABIA")][0]
    status_f = col(orders, "o_orderstatus") == code_of(
        orders, "o_orderstatus", "F")
    m = late & other & ~other_late & status_f[oi] & \
        (col(supp, "s_nationkey")[si] == saudi)
    counts = np.bincount(si[m], minlength=supp.num_rows)
    names = names_of(supp, "s_name")
    rows = sorted(((-int(c), names[k]) for k, c in enumerate(counts) if c),
                  key=lambda r: (r[0], r[1]))
    return [(nm, -c) for c, nm in rows[:100]], int(m.sum())


def decimal_ints(values, scale: int):
    """Decimal results of a query as integers at `scale`."""
    import decimal
    return [int(decimal.Decimal(v).scaleb(scale)) for v in values]


def check_full_lowering(q, out, tables):
    """Q7, Q8, Q9, Q10, Q12, Q14, Q18 or Q21's result `out` against its
    numpy oracle, exactly; returns a line that says what agreed."""
    got = out.to_pydict()
    if q == 7:
        want = oracle_q7(tables)
        rows = list(zip(got["supp_nation"], got["cust_nation"],
                        got["l_year"], decimal_ints(got["revenue"], 4)))
        ok, say = rows == want, f"{len(want)} groups {want}"
    elif q == 8:
        want = oracle_q8(tables)
        rows = list(zip(got["o_year"], decimal_ints(got["mkt_share"], 8)))
        ok, say = rows == want, f"shares (scale 8) {want}"
    elif q == 9:
        want = oracle_q9(tables)
        rows = list(zip(got["nation"], got["o_year"],
                        decimal_ints(got["sum_profit"], 4)))
        ok, say = rows == want, f"{len(want)} (nation, year) groups"
    elif q == 10:
        want, n = oracle_q10(tables)
        rows = list(zip(got["c_custkey"], got["c_name"],
                        decimal_ints(got["revenue"], 4),
                        decimal_ints(got["c_acctbal"], 2), got["n_name"],
                        got["c_address"], got["c_phone"], got["c_comment"]))
        ok, say = rows == want, f"top 20 of {n} customers, {want[:2]}"
    elif q == 12:
        want = oracle_q12(tables)
        rows = list(zip(got["l_shipmode"], got["high_line_count"],
                        got["low_line_count"]))
        ok, say = rows == want, f"{want}"
    elif q == 14:
        promo, total = oracle_q14(tables)
        want = 100.0 * (promo / 1e4) / (total / 1e4)
        ok, say = got["promo_revenue"] == [want], f"{want}"
    elif q == 18:
        want, n = oracle_q18(tables)
        rows = list(zip(got["c_name"], got["c_custkey"], got["o_orderkey"],
                        [days(d.year, d.month, d.day)
                         for d in got["o_orderdate"]],
                        decimal_ints(got["o_totalprice"], 2),
                        decimal_ints(got["sum(lineitem.l_quantity)"], 2)))
        ok, say = rows == want, f"{len(want)} of {n} large orders"
    else:
        want, n = oracle_q21(tables)
        rows = list(zip(got["s_name"], got["numwait"]))
        ok, say = rows == want, f"{n} waiting lines, top {want[:3]}"
    if not ok:
        raise AssertionError(f"Q{q} SF10 disagrees with numpy:\n{got}\n"
                             f"{want}")
    return f"Q{q} SF10 equals numpy exactly: {say}"


FULL_LOWERING = (7, 8, 9, 10, 12, 14, 18, 21)


def full_lowering_phase(ctx, tables, card, add):
    """TPC-H Q7-Q10, Q12, Q14, Q18 and Q21 at SF10, the chains that need the
    full expression lowering (CASE, date_part, `/`), the functional-
    dependence key reduction (Q10, Q18) or the SEMI/ANTI min/max
    membership (Q21): `chain_build` against its plain version on Q21's
    builds (the two lineitem min/max tables), `chain_aggregate` against
    its plain version on every one of their walks (Q18's reduced walk with
    its representative-row lane, Q9's date_part keys, Q12's and Q14's CASE
    sums, Q21's min/max hops); then each query end to end against numpy
    with 0 fallbacks, its kernels launched (the walk one launch a pass of
    lanes), and a breakdown. Returns the kernels line's entries of the
    parts of rows 15 and 16 that Q5's entries leave out, each with its
    kernel's launches in its query's main-path run: `chain_build[mmx]`,
    Q21's largest min/max build, `chain_aggregate[fd]`, Q18's reduced
    walk, and `chain_aggregate[Q9]` and `chain_aggregate[Q12]`, the walks
    bound by their hops and hash fold and by their predicate."""
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH
    tctx = ctx.task_context()
    execs = {q: find_exec(ctx.sql(TPCH[q]).create_physical_plan(),
                          TorchJoinChainAggregateExec) for q in FULL_LOWERING}
    stage = {}
    for q, ex in execs.items():
        if ex is None:
            raise AssertionError(f"Q{q} plans no TorchJoinChainAggregateExec")
        print(f"Q{q} SF10 plans {ex.display_line()}", flush=True)
        stage[q] = staging_kernels(ex, tctx, q)
    kb21, builds21 = chain_builds_vs_plain(execs[21], tctx, card, "Q21 SF10",
                                           mmx_only=True)
    walk = "datafusion_tpu/physical/plan/device_join_chain.py:1597"
    variants = {
        "chain_build[mmx]": (21, "chain_build", kb21,
                             "datafusion_tpu/physical/plan/"
                             "device_join_chain.py:1158"),
        "chain_aggregate[fd]": (18, "chain_aggregate", chain_walk_vs_plain(
            execs[18], tctx, card, "Q18 SF10"),
            "datafusion_tpu/physical/plan/device_join_chain.py:1501")}
    # the walks bound by their predicate (Q12) and by their hops and hash
    # fold (Q9), beside Q5's in the kernels line
    for q in FULL_LOWERING:
        if q != 18:
            ent = chain_walk_vs_plain(execs[q], tctx, card, f"Q{q} SF10")
            if q in (9, 12):
                variants[f"chain_aggregate[Q{q}]"] = (
                    q, "chain_aggregate", ent, walk)
    compose_vs_plain(execs[21], tctx, card, "Q21 SF10")
    del execs
    import torch
    torch.cuda.empty_cache()
    li = tables["lineitem"]
    out_entries = {}
    for q in FULL_LOWERING:
        expect = ["chain_build", "chain_aggregate", "compact_groups"] + \
            stage[q]
        if q == 18:
            expect.append("hash_group_aggregate")
        cold = cold_staging(ctx, TPCH[q], tctx, f"Q{q} SF10",
                            builds21 if q == 21 else None)
        out, counts, _ = run_path(ctx, TPCH[q], expect, card, f"Q{q} SF10",
                                  li.num_rows, TorchJoinChainAggregateExec,
                                  cold=cold)
        add(counts)
        launched_as_predicted(f"Q{q} SF10", counts, {
            "chain_aggregate": WALK_LAUNCHES[f"Q{q} SF10"]})
        for name, (vq, kernel, ent, replaces) in variants.items():
            if vq == q:
                out_entries[name] = dict(
                    name=name, route="cuda",
                    source=kernels.KERNELS[kernel].source,
                    replaces=replaces, launches=counts[kernel], **ent)
        no_fallbacks(ctx, TPCH[q], f"Q{q} SF10")
        print(check_full_lowering(q, out, tables), flush=True)
        breakdown(ctx, TPCH[q], card, f"Q{q} SF10",
                  TorchJoinChainAggregateExec)
        del out
    torch.cuda.empty_cache()
    return list(out_entries.values())



# ---- count(DISTINCT x), lanes past 32, the fanout-N join-aggregate ---------

def distinct_vs_plain(ctx, sql, label, card):
    """`hash_group_aggregate` with its distinct lane against its plain
    version on the query's staged inputs: equal group tables (ordered by
    key) and equal sets of distinct pairs. The bound reads the inputs once
    and writes each live group's slot and each distinct pair's entry
    (24 bytes) once. Returns (the report entry, distinct pairs, the set's
    bytes)."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        compact_groups_plain, hash_group_aggregate,
        hash_group_aggregate_plain)
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    ex = find_exec(ctx.sql(sql).create_physical_plan(),
                   TorchGroupAggregateExec)
    (batch,) = ex.input_batches(ctx.task_context())
    spec, _plan, _names, _slots = ex.compile([batch])
    cols, aux = ex.stage(spec, batch)
    n, dev = batch.num_rows, ctx.device
    tables, sets = [], []
    for fold in (hash_group_aggregate, hash_group_aggregate_plain):
        table = spec.new_table(dev)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        dset = spec.distinct_set(n, dev)
        fold(spec, cols, aux, n, table, overflow, dset=dset)
        torch.cuda.synchronize()
        if int(overflow.item()) or dset.overflowed():
            raise AssertionError(f"{label}: {fold.__name__} overflowed")
        set_bytes = dset.nbytes
        sets.append(dset.pairs())
        tables.append(compact_groups_plain(table).cpu().numpy())
        del dset, table
    got, want = (t[:, np.argsort(t[0], kind="stable")] for t in tables)
    if got.shape != want.shape or not np.array_equal(got, want) or \
            not torch.equal(sets[0], sets[1]):
        raise AssertionError(f"{label}: the distinct fold differs from its "
                             f"plain version")
    pairs = sets[0].shape[0]
    del sets, tables
    scratch = spec.new_table(dev)
    pristine = scratch.clone()
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    dset = spec.distinct_set(n, dev)

    def reset():
        scratch.copy_(pristine)
        dset.words.zero_()
    ms = cuda_ms(lambda: hash_group_aggregate(spec, cols, aux, n, scratch,
                                              overflow, dset), 3,
                 setup=reset)
    plain = cuda_ms(lambda: hash_group_aggregate_plain(
        spec, cols, aux, n, scratch, overflow, dset=dset), 1, setup=reset)
    del scratch, pristine, dset
    torch.cuda.empty_cache()
    groups, rows = got.shape[1], got.shape[0]
    bnd = bound(col_bytes(cols, spec.pools.columns, n) +
                groups * rows * 8 + pairs * 24, prog_ops(spec, n))
    print(f"hash_group_aggregate[distinct] {label}: {n} rows, {groups} "
          f"groups, {spec.cap} slots "
          f"({'identity' if spec.identity_slots else 'hashed'}), "
          f"{len(spec.lanes)} lanes, {pairs} distinct pairs in a set of "
          f"{set_bytes} bytes: kernel {ms:.6f} ms, plain {plain:.6f} ms, "
          f"bound {bnd['bound_ms']:.6f} ms ({bnd['bytes']} bytes), "
          f"max_abs_err 0 [{card}]", flush=True)
    return entry(0.0, ms, plain, bnd), pairs, set_bytes


def join_ops(spec, n_probe: int, pairs: int) -> int:
    """Interpreter ops of a join-aggregate: the probe predicate and keys
    once a probe row, the residual, group keys and lanes once a pair."""
    probe = sum(len(p.code) for p in spec.join.programs())
    pair = sum(len(p.code) for p in spec.programs()) - probe
    return n_probe * probe + pairs * pair


def join_vs_plain(ctx, sql, label, card):
    """`join_build` against its plain version on the query's build side
    (equal int32 bucket starts, the same multiset of (row, record) a
    bucket), then `join_aggregate` over the kernel's table against its
    plain version on the probe batch (equal group tables, ordered by key;
    every lane is a count or an exact decimal sum). Bounds: the build's
    inputs (keys and payload columns) read and its CSR and records written
    once; the probe columns and the CSR with its records (which carry the
    build columns the pairs read) read once, the live groups written once.
    Returns (join_build's entry, join_aggregate's entry, pairs)."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.groupby import (
        AggregateSpec, compact_groups_plain, dense_group_table)
    from datafusion_tpu_torch.device.join_agg import (
        join_aggregate, join_aggregate_plain, join_build, join_build_plain,
        join_pairs_plain)
    from datafusion_tpu_torch.physical.plan.base import (collect_batch,
                                                         execute_stream)
    from datafusion_tpu_torch.physical.plan.device_join_agg import (
        TorchJoinAggregateExec)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        _PairView)
    ex = find_exec(ctx.sql(sql).create_physical_plan(),
                   TorchJoinAggregateExec)
    if ex is None:
        raise AssertionError(f"{label} plans no TorchJoinAggregateExec")
    print(f"{label} plans {ex.display_line()}", flush=True)
    tctx = ctx.task_context()
    lowered = ex.lower()
    bb = collect_batch(ex.build_source, tctx)
    bspec, bcols, baux = ex.build_input(lowered, bb)
    nb_rows = bb.num_rows
    got_t = join_build(bspec, bcols, baux, nb_rows)
    want_t = join_build_plain(bspec, bcols, baux, nb_rows)
    torch.cuda.synchronize()
    if (got_t.nb, got_t.live) != (want_t.nb, want_t.live) or \
            not torch.equal(got_t.start, want_t.start) or not all(
                np.array_equal(a, b) for a, b in zip(got_t.entries(),
                                                     want_t.entries())):
        raise AssertionError(f"{label}: join_build differs from its plain "
                             f"version")
    del want_t
    ms_b = cuda_ms(lambda: join_build(bspec, bcols, baux, nb_rows), 5)
    plain_b = cuda_ms(lambda: join_build_plain(bspec, bcols, baux, nb_rows),
                      2)
    bnd_b = bound(col_bytes(bcols, set(bspec.pools.columns) |
                            set(bspec.payload), nb_rows) +
                  got_t.nbytes, prog_ops(bspec, nb_rows))
    print(f"join_build {label}: {nb_rows} build rows, {got_t.live} live, "
          f"{got_t.nb} buckets, records of {8 * got_t.width} bytes, CSR of "
          f"{got_t.nbytes} bytes: kernel "
          f"{ms_b:.6f} ms, plain {plain_b:.6f} ms, bound "
          f"{bnd_b['bound_ms']:.6f} ms, max_abs_err 0 [{card}]", flush=True)
    (pb,) = [b for b in execute_stream(ex.probe_source, tctx) if b.num_rows]
    view = _PairView(list(bb.columns) + list(pb.columns), pb.num_rows)
    spec, _plan, _names, _sm = ex.compile_join(lowered, got_t, [view])
    cols, aux = ex.stage_pair(spec, bb, pb, view)
    n, dev = pb.num_rows, ctx.device
    pairs = join_pairs_plain(spec, cols, aux, n)[0].numel()
    dense = isinstance(spec, AggregateSpec)
    tables = []
    for fold in (join_aggregate, join_aggregate_plain):
        table = spec.new_table(dev)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        fold(spec, cols, aux, n, table, overflow)
        torch.cuda.synchronize()
        if int(overflow.item()):
            raise AssertionError(f"{label}: {fold.__name__} overflowed")
        tables.append(compact_groups_plain(
            dense_group_table(table) if dense else table).cpu().numpy())
        del table
        torch.cuda.empty_cache()
    got, want = (t[:, np.argsort(t[0], kind="stable")] for t in tables)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{label}: join_aggregate's group table "
                             f"differs from its plain version")
    scratch = spec.new_table(dev)
    pristine = scratch.clone()
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    ms_a = cuda_ms(lambda: join_aggregate(spec, cols, aux, n, scratch,
                                          overflow), 5,
                   setup=lambda: scratch.copy_(pristine))
    plain_a = cuda_ms(lambda: join_aggregate_plain(spec, cols, aux, n,
                                                   scratch, overflow), 1,
                      setup=lambda: scratch.copy_(pristine))
    del scratch, pristine
    torch.cuda.empty_cache()
    nbuild = spec.join.n_build
    groups, rows = got.shape[1], got.shape[0]
    # the build columns the pairs read are in the table's records
    nbytes = (col_bytes(cols, [i for i in spec.pools.columns
                               if i >= nbuild], n) + got_t.nbytes +
              groups * rows * 8)
    bnd_a = bound(nbytes, join_ops(spec, n, pairs))
    print(f"join_aggregate {label}: {n} probe rows, {pairs} pairs, "
          f"{'dense' if dense else 'hash'} fold, {groups} groups: kernel "
          f"{ms_a:.6f} ms, plain {plain_a:.6f} ms, bound "
          f"{bnd_a['bound_ms']:.6f} ms ({bnd_a['bytes']} bytes), "
          f"max_abs_err 0 [{card}]", flush=True)
    return entry(0.0, ms_b, plain_b, bnd_b), entry(0.0, ms_a, plain_a,
                                                    bnd_a), pairs


def oracle_q5d(t):
    """Q5 with count(DISTINCT o_custkey): (nation name, revenue at scale
    4, distinct customers), by revenue descending."""
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
    ck = col(orders, "o_custkey")[oi]
    c_nat = col(cust, "c_nationkey")[ck - 1]
    m = o_ok[oi] & (c_nat == s_nat) & n_in[s_nat]
    rev = col(li, "l_extendedprice")[m] * (100 - col(li, "l_discount")[m])
    nat, ck = s_nat[m], ck[m]
    names = nation.column_by_name("n_name")
    out = [(names.dictionary.values[col(nation, "n_name")[k]],
            int(rev[nat == k].sum()), len(np.unique(ck[nat == k])))
           for k in np.flatnonzero(n_in) if (nat == k).any()]
    return sorted(out, key=lambda r: -r[1])


def oracle_j1(t):
    """J1: (ps_suppkey, pairs, sum(ps_supplycost * l_quantity) at scale 4)
    of every supplier, by key: a part's lineitem count and quantity, spread
    over its partsupp rows."""
    import numpy as np
    li, ps = t["lineitem"], t["partsupp"]
    part = col(li, "l_partkey")
    n_part = int(col(ps, "ps_partkey").max()) + 1
    cnt = np.bincount(part, minlength=n_part)
    qty = np.bincount(part, weights=col(li, "l_quantity"),
                      minlength=n_part).astype(np.int64)
    pp, sk = col(ps, "ps_partkey"), col(ps, "ps_suppkey")
    pairs = np.bincount(sk, weights=cnt[pp]).astype(np.int64)
    # every partial sum stays below 2^53, so float64 adds are exact
    cost = np.bincount(sk, weights=col(ps, "ps_supplycost") * qty[pp]) \
        .astype(np.int64)
    keys = np.flatnonzero(pairs)
    return keys, pairs[keys], cost[keys]


def oracle_j2(t):
    """J2: (ps_suppkey, sum(l_extendedprice * (1 - l_discount) -
    ps_supplycost * l_quantity) at scale 4) of every supplier, by key: each
    lineitem meets the partsupp row of its (part, supplier), the part's
    row of the supplier's position among its 4."""
    import numpy as np
    li, ps = t["lineitem"], t["partsupp"]
    part, supp = col(li, "l_partkey"), col(li, "l_suppkey")
    n_supp = int(col(ps, "ps_suppkey").max())
    j = ((supp - part) % n_supp) // (n_supp // 4 + 1)
    row = (part - 1) * 4 + j
    if not np.array_equal(col(ps, "ps_suppkey")[row], supp):
        raise AssertionError("J2's oracle found another partsupp row")
    profit = (col(li, "l_extendedprice") * (100 - col(li, "l_discount")) -
              col(ps, "ps_supplycost")[row] * col(li, "l_quantity"))
    # every partial sum stays below 2^53, so float64 adds are exact
    out = np.bincount(supp, weights=profit, minlength=n_supp + 1) \
        .astype(np.int64)
    keys = np.flatnonzero(np.bincount(supp, minlength=n_supp + 1))
    return keys, out[keys]


def launched_as_predicted(label, counts, per_query, runs=REPS + 1):
    """Fails unless each kernel of `per_query` launched that many times a
    run of the main path."""
    bad = {k: counts[k] for k, n in per_query.items()
           if counts[k] != n * runs}
    if bad:
        raise AssertionError(f"{label}: launches {bad}, predicted "
                             f"{per_query} a run")


def join_agg_phase(ctx, tables, card, add, report):
    """TPC-H at SF10 through the join-aggregate and the chain's distinct
    lane: `join_build` and `join_aggregate` against their plain versions on
    J1 (lineitem x partsupp on the part key: fanout 4) and J2 (Q9's profit
    through the composite key), `chain_aggregate` with the distinct lane
    against its plain version on Q5D (Q5 with count(DISTINCT o_custkey));
    then J1, J2 and Q5D end to end against numpy, with 0 fallbacks and a
    breakdown each. Sets report["join_build"] and report["join_aggregate"]
    (J1's) and returns the kernels line's `chain_aggregate[distinct]`
    entry, with chain_aggregate's launches in Q5D's main-path run."""
    import numpy as np
    import torch
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.physical.plan.device_join_agg import (
        TorchJoinAggregateExec)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    li = tables["lineitem"]
    report["join_build"], report["join_aggregate"], pairs1 = join_vs_plain(
        ctx, J1, "J1 SF10", card)
    _kb, _ka, pairs2 = join_vs_plain(ctx, J2, "J2 SF10", card)
    ex = find_exec(ctx.sql(Q5D).create_physical_plan(),
                   TorchJoinChainAggregateExec)
    print(f"Q5D SF10 plans {ex.display_line()}", flush=True)
    k5 = chain_walk_vs_plain(ex, ctx.task_context(), card, "Q5D SF10")
    del ex
    torch.cuda.empty_cache()
    join = ["join_build", "join_aggregate", "compact_groups"]
    for label, sql, oracle, pairs in (("J1 SF10", J1, oracle_j1, pairs1),
                                      ("J2 SF10", J2, oracle_j2, pairs2)):
        out, counts, _ = run_path(ctx, sql, join, card, label, li.num_rows,
                                  TorchJoinAggregateExec)
        add(counts)
        # hash, count, the scan's three, scatter; one probe launch
        launched_as_predicted(label, counts, {"join_build": 6,
                                              "join_aggregate": 1})
        no_fallbacks(ctx, sql, label)
        want = oracle(tables)
        got = [c.data_host() for c in out.columns]
        if len(got) != len(want) or not all(
                np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label} disagrees with numpy")
        print(f"{label} equals numpy exactly: {len(want[0])} suppliers, "
              f"{pairs} pairs, first sums {got[-1][:3].tolist()} (scale 4)",
              flush=True)
        breakdown(ctx, sql, card, label, TorchJoinAggregateExec,
                  main="join_aggregate")
    out, counts, _ = run_path(ctx, Q5D, ["chain_build", "chain_aggregate",
                                         "compact_groups"],
                              card, "Q5D SF10", li.num_rows,
                              TorchJoinChainAggregateExec,
                              cold=cold_staging(ctx, Q5D, ctx.task_context(),
                                                "Q5D SF10"))
    add(counts)
    launched_as_predicted("Q5D SF10", counts, {"chain_aggregate": 1})
    no_fallbacks(ctx, Q5D, "Q5D SF10")
    want = oracle_q5d(tables)
    got = list(zip(out.columns[0].to_pylist(), col(out, "revenue").tolist(),
                   col(out, "customers").tolist()))
    if got != want:
        raise AssertionError(f"Q5D SF10 disagrees with numpy: {got} {want}")
    print(f"Q5D SF10 equals numpy exactly: {got}", flush=True)
    breakdown(ctx, Q5D, card, "Q5D SF10", TorchJoinChainAggregateExec)
    torch.cuda.empty_cache()
    return [dict(name="chain_aggregate[distinct]", route="cuda",
                 source=kernels.KERNELS["chain_aggregate"].source,
                 replaces="datafusion_tpu/physical/plan/"
                          "device_join_chain.py:1459",
                 launches=counts["chain_aggregate"], **k5)]


CACHE_WARM_RUNS = 3


def check_q3(out, tables, label, segment="BUILDING"):
    """Fails unless Q3's output (of market segment `segment`) equals
    `oracle_q3`'s."""
    import numpy as np
    keys, revs, dates, n_groups = oracle_q3(tables, segment)
    if not (np.array_equal(col(out, "l_orderkey"), keys) and
            np.array_equal(col(out, "revenue"), revs) and
            np.array_equal(col(out, "o_orderdate"), dates) and
            not col(out, "o_shippriority").any()):
        raise AssertionError(f"{label} disagrees with numpy:\n"
                             f"{out.to_pydict()}\n{keys} {revs} {dates}")
    return (f"equals numpy exactly: {n_groups} groups, top revenue "
            f"{revs[:3].tolist()} (scale 4)")


def check_q5(out, tables, label, year=1994, region_name="ASIA"):
    want = oracle_q5(tables, year, region_name)
    got = list(zip(out.columns[0].to_pylist(), col(out, "revenue").tolist()))
    if got != want:
        raise AssertionError(f"{label} disagrees with numpy: {got} {want}")
    return f"equals numpy exactly: {got}"


def check_q2(out, tables, label):
    want, n = oracle_q2(tables)
    got = {c: out.column_by_name(c).to_pylist()
           if out.column_by_name(c).dictionary is not None
           else col(out, c).tolist() for c in want}
    if got != want:
        raise AssertionError(f"{label} disagrees with numpy:\n{got}\n{want}")
    return f"equals numpy exactly: {n} rows at their part's least cost"


def timed_run(ctx, sql):
    """(result batch, ms, {kernel: launches} of `chain_build`,
    `chain_compose` and `chain_fold`) of one run of `sql`."""
    from datafusion_tpu_torch import kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = ctx.sql(sql).collect_batch()
    ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    return out, ms, {k: counts[k] for k in STAGING}


def cold_then_warm(ctx, q, sql, check, walk, tables, card):
    """TPC-H query `q` at SF10 run cold, after the session's chain caches
    are emptied (held to `cold_staging`), then CACHE_WARM_RUNS times warm,
    each run held to `warm_staging` and to the cold run's rows, the walk
    launched every run. Returns the cold run's rows."""
    from datafusion_tpu_torch import kernels
    label = f"Q{q} SF10 caches"
    caches = ctx.chain_caches
    want = cold_staging(ctx, sql, ctx.task_context(), f"Q{q} SF10")
    caches.clear()
    out, cold_ms, cold = timed_run(ctx, sql)
    if cold != want or not cold["chain_build"]:
        raise AssertionError(f"{label}: the cold run launched {cold}, not "
                             f"{want}")
    say = check(out, tables, label)
    rows = out.to_pydict()
    cold_bytes = cache_bytes(caches)
    warm_ms, walks = [], 0
    want = warm_staging(f"Q{q} SF10", cold["chain_mask"])
    for _ in range(CACHE_WARM_RUNS):
        out, ms, warm = timed_run(ctx, sql)
        warm_ms.append(ms)
        walks += kernels.launch_counts()[walk]
        if warm != want:
            raise AssertionError(f"{label}: a warm run launched {warm}, not "
                                 f"{want}")
        if out.to_pydict() != rows:
            raise AssertionError(f"{label}: a warm run's rows differ from "
                                 f"the cold run's")
    if walks < CACHE_WARM_RUNS:
        raise AssertionError(f"{label}: the warm runs launched {walk} "
                             f"{walks} times")
    no_fallbacks(ctx, sql, label)
    print(f"{label}: cold {cold_ms:.3f} ms (launches {cold}), warm "
          f"{[round(x, 3) for x in warm_ms]} ms (launches {want} each, "
          f"{walk} {walks}); chain caches after the cold run {cold_bytes} "
          f"bytes, after the warm runs {cache_bytes(caches)}; {say} [{card}]",
          flush=True)
    return rows


def cache_phase(ctx, tables, card):
    """The join chain's cross-query caches and the MemoryPool on the card.
    TPC-H Q5, Q2 and Q21 at SF10 each run cold, then warm
    (`cold_then_warm`): Q5's warm runs launch no `chain_build`,
    `chain_compose` or `chain_fold`, Q2's only those of its
    subquery-fed build (WARM_STAGING), Q21's those of its two min/max
    tables; every run one `chain_mask` a masked side. Between Q5 and Q2,
    Q5 with its dates a year later (a new literal in its orders build,
    whose unfiltered table is unfit at SF10: the orders side alone builds,
    its two launches, and only a composition or a fold that reads it is
    staged; the rows equal numpy's), then Q5 as before once more, each
    timed; Q3 through the five market segments twice (`q3_segments`); Q5
    with r_name ASIA, EUROPE, ASIA (`q5_regions`); and `chain_mask`
    against its plain version on Q3's customer and Q8's part
    (`mask_vs_plain`). Then Q5 under a GreedyMemoryPool of its build
    batches' bytes and half the caches' bytes gives the cold run's rows
    with the caches at or below half, and pools one byte short of Q5's
    build batches and of J1's build batch raise ResourcesExhausted with no
    fallback. Prints each query's cold and warm ms and the caches' bytes
    by part. Returns the kernels line's entry of `chain_mask` (Q3's
    customer)."""
    from datafusion_tpu_torch.common.errors import ResourcesExhausted
    from datafusion_tpu_torch.physical.plan.base import collect_batch
    from datafusion_tpu_torch.physical.plan.device_join_agg import (
        TorchJoinAggregateExec)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    from datafusion_tpu_torch.runtime.memory import GreedyMemoryPool
    from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH
    caches = ctx.chain_caches
    tctx = ctx.task_context()
    sql5 = TPCH[5]
    sql95 = sql5.replace("1995-01-01", "1996-01-01").replace(
        "1994-01-01", "1995-01-01")
    old, unfit = set(), set()
    for ex in chain_execs(ctx, sql5):
        old |= {name for name, _n, _m in
                build_sides(ex, tctx, found=unfit)[0]}
    (ex95,) = chain_execs(ctx, sql95)
    # the warm runs before it found the unfit unfiltered tables (orders')
    sides, composed, folded = build_sides(ex95, tctx, known=unfit)
    fresh = [(name, n) for name, n, _m in sides if name not in old]
    # the hops whose table or composed words are new: a composition or a
    # fold that reads one is staged again
    new = {h for h, (name, _n, _m) in enumerate(sides) if name not in old}
    new |= {o for h, (o, _t) in composed.items() if h in new or o in new}
    want = {"chain_build": sum(n for _name, n in fresh),
            "chain_compose": int(any(h in new for h in composed)
                                 or any(o in new
                                        for o, _t in composed.values())),
            "chain_fold": int(any(h in new for h in folded)),
            "chain_mask": sum(m for _name, _n, m in sides)}
    rows = {5: cold_then_warm(ctx, 5, sql5, check_q5, "chain_aggregate",
                              tables, card)}

    # == a new literal ========================================================
    warm_bytes = cache_bytes(caches)
    out, ms95, got = timed_run(ctx, sql95)
    if got != want:
        raise AssertionError(f"Q5 SF10 in 1995: launched {got}, not {want} "
                             f"(the build sides {fresh} are new)")
    say = check_q5(out, tables, "Q5 SF10 in 1995", 1995)
    new_bytes = cache_bytes(caches)
    out, ms94, back = timed_run(ctx, sql5)
    if out.to_pydict() != rows[5]:
        raise AssertionError("Q5 SF10 after the 1995 run: its rows differ")
    print(f"Q5 SF10 with o_orderdate in 1995 after the warm 1994 runs: "
          f"{ms95:.3f} ms, launches {got} (new build sides {fresh}), chain "
          f"caches {warm_bytes} -> {new_bytes} bytes, {say}; Q5 in 1994 "
          f"again: {ms94:.3f} ms, launches {back}, the cold run's rows, "
          f"caches {cache_bytes(caches)} [{card}]", flush=True)

    q3_segments(ctx, tables, card)
    q5_regions(ctx, tables, card)
    entry_mask = None
    for q in (3, 8):
        ex = find_exec(ctx.sql(TPCH[q]).create_physical_plan(),
                       TorchJoinChainAggregateExec)
        clear_chain_caches(ex)
        staged = ex.stage_builds(tctx, compose=False)
        bi = max((s for s in staged if masked(s)),
                 key=lambda s: s.batch.num_rows)
        ent = mask_vs_plain(bi, card, f"Q{q} SF10 ({bi.batch.num_rows} "
                            f"rows)")
        entry_mask = entry_mask or ent
        clear_chain_caches(ex, staged)
        del staged, bi
    rows[2] = cold_then_warm(ctx, 2, TPCH[2], check_q2, "chain_rows",
                             tables, card)
    rows[21] = cold_then_warm(
        ctx, 21, TPCH[21], lambda out, t, _l: check_full_lowering(21, out, t),
        "chain_aggregate", tables, card)

    # == the MemoryPool =======================================================
    sql5 = TPCH[5]
    ex5 = find_exec(ctx.sql(sql5).create_physical_plan(),
                    TorchJoinChainAggregateExec)
    builds = sum(bi.batch.nbytes() for bi in ex5.build_inputs(tctx))
    ctx.sql(sql5).collect_batch()                  # the caches warm
    held = caches.device_cache_bytes()
    runtime, fell = ctx.runtime, ex5.fallbacks
    base = runtime.memory_pool
    try:
        runtime.memory_pool = GreedyMemoryPool(builds + held // 2)
        out = ctx.sql(sql5).collect_batch()
        left = caches.device_cache_bytes()
        if out.to_pydict() != rows[5]:
            raise AssertionError("Q5 SF10 under a pool: its rows differ")
        if left > held // 2 or ex5.fallbacks != fell:
            raise AssertionError(f"Q5 SF10 under a pool of {builds} + "
                                 f"{held // 2} bytes: caches hold {left}, "
                                 f"fallbacks {ex5.fallbacks - fell}")
        print(f"Q5 SF10 under GreedyMemoryPool({builds} build bytes + "
              f"{held // 2}, half of the caches' {held}): the cold run's "
              f"rows; the caches "
              f"evicted to {left} bytes {cache_bytes(caches)} [{card}]",
              flush=True)
        exj = find_exec(ctx.sql(J1).create_physical_plan(),
                        TorchJoinAggregateExec)
        j1 = collect_batch(exj.build_source, tctx).nbytes()
        for label, sql, ex, need in (("Q5 SF10", sql5, ex5, builds),
                                     ("J1 SF10", J1, exj, j1)):
            before = getattr(ex, "fallbacks", 0)
            runtime.memory_pool = GreedyMemoryPool(need - 1)
            try:
                ctx.sql(sql).collect_batch()
            except ResourcesExhausted as e:
                raised = str(e)
            else:
                raise AssertionError(f"{label}: a pool of {need - 1} "
                                     f"bytes did not stop it")
            if getattr(ex, "fallbacks", 0) != before:
                raise AssertionError(f"{label}: ResourcesExhausted became a "
                                     f"fallback")
            print(f"{label} under GreedyMemoryPool({need - 1}), one byte "
                  f"short of its build batches' {need}: ResourcesExhausted "
                  f"({raised[:120]}), no fallback", flush=True)
    finally:
        runtime.memory_pool = base
    return entry_mask


SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")


def q3_segments(ctx, tables, card):
    """TPC-H Q3 at SF10 through the five market segments, twice in turn,
    from emptied caches: each run's rows equal numpy's (`check_q3`), each
    launches one `chain_mask` (customer's unfiltered table masked by the
    segment; orders' is unfit at SF10, 2^26 slots as the reference packs
    it, so its side keeps its own table); the first run stages as
    `cold_staging` says, and no later run launches `chain_build`,
    `chain_compose` or `chain_fold`. The INNER part holds one unfiltered
    customer entry throughout. Prints each run's ms and the INNER part's
    bytes."""
    from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH
    caches = ctx.chain_caches
    cust = (tables["customer"].column_by_name("c_custkey")._uid,)
    sqls = [TPCH[3].replace("'BUILDING'", f"'{s}'") for s in SEGMENTS]
    first = cold_staging(ctx, sqls[0], ctx.task_context(), "Q3 SF10")
    warm = dict(dict.fromkeys(STAGING, 0), chain_mask=1)
    caches.clear()
    log = []
    for i, (seg, sql) in enumerate(zip(SEGMENTS * 2, sqls * 2)):
        label = f"Q3 SF10 {seg} (run {i + 1})"
        out, ms, got = timed_run(ctx, sql)
        want = first if i == 0 else warm
        if got != want or got["chain_mask"] != 1:
            raise AssertionError(f"{label}: launched {got}, not {want}")
        check_q3(out, tables, label, seg)
        held = [k for k in caches.parts["inner"].entries
                if k[0] == "unfiltered" and k[2] == cust]
        if len(held) != 1:
            raise AssertionError(f"{label}: the INNER part holds "
                                 f"{len(held)} unfiltered customer tables")
        log.append((seg, round(ms, 3), caches.parts["inner"].nbytes))
    print(f"Q3 SF10 through {len(SEGMENTS)} segments twice, each equal to "
          f"numpy: the first run launched {first}, each later one {warm}; "
          f"one unfiltered customer table throughout; (segment, ms, INNER "
          f"bytes) {log} [{card}]", flush=True)


def q5_regions(ctx, tables, card):
    """TPC-H Q5 at SF10 with r_name ASIA, EUROPE, ASIA after a run of
    ASIA's that warms the caches: each run's rows equal numpy's
    (`check_q5`), EUROPE's differ from ASIA's, every run launches one
    `chain_mask` (region's table) and no `chain_build`; EUROPE composes
    the words that read region anew (one `chain_compose`), and the second
    ASIA launches no `chain_compose` or `chain_fold`: words and records
    are keyed by the build predicate of every hop they read."""
    from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH
    ctx.chain_caches.clear()
    ctx.sql(TPCH[5]).collect_batch()
    log, rows = [], {}
    for r in ("ASIA", "EUROPE", "ASIA"):
        label = f"Q5 SF10 r_name = {r}"
        out, ms, got = timed_run(ctx, TPCH[5].replace("'ASIA'", f"'{r}'"))
        check_q5(out, tables, label, 1994, r)
        fresh = r not in rows
        if got["chain_build"] or got["chain_mask"] != 1 or \
                (got["chain_compose"] != 1 if fresh and rows else
                 got["chain_compose"] or got["chain_fold"]):
            raise AssertionError(f"{label}: launched {got}")
        if not fresh and out.to_pydict() != rows[r]:
            raise AssertionError(f"{label}: its rows changed")
        rows[r] = out.to_pydict()
        log.append((r, round(ms, 3), got))
    if rows["ASIA"] == rows["EUROPE"]:
        raise AssertionError("Q5 SF10: EUROPE gave ASIA's rows")
    print(f"Q5 SF10 by region, each equal to numpy, EUROPE's rows not "
          f"ASIA's: (r_name, ms, launches) {log} [{card}]", flush=True)


def oracle_q1(li):
    """Q1's (returnflag * 2 + linestatus, count_order, sum_charge at scale
    6) of `make_lineitem`'s rows, by group."""
    import numpy as np
    ship = col(li, "l_shipdate")
    m = ship <= days(1998, 9, 2)
    g = (col(li, "l_returnflag") * 2 + col(li, "l_linestatus"))[m]
    charge = (col(li, "l_extendedprice") * (100 - col(li, "l_discount")) *
              (100 + col(li, "l_tax")))[m]
    keys = np.unique(g)
    return {int(k): (int((g == k).sum()), int(charge[g == k].sum()))
            for k in keys}


def oracle_q15(t):
    """Q15's revenue0: (supplier, revenue at scale 4) of every supplier
    with a line shipped in 1996 Q1."""
    import numpy as np
    li = t["lineitem"]
    ship, supp = col(li, "l_shipdate"), col(li, "l_suppkey")
    m = (ship >= days(1996, 1, 1)) & (ship < days(1996, 4, 1))
    rev = np.zeros(int(supp.max()) + 1, np.int64)
    np.add.at(rev, supp[m], col(li, "l_extendedprice")[m] *
              (100 - col(li, "l_discount")[m]))
    live = np.zeros(len(rev), bool)
    live[supp[m]] = True
    return np.flatnonzero(live), rev[live]


def check_q1(out, li, label):
    """Fails unless Q1's output equals `oracle_q1` over `li`."""
    want = oracle_q1(li)
    got = {int(a) * 2 + int(b): (int(c), int(d)) for a, b, c, d in zip(
        col(out, "l_returnflag"), col(out, "l_linestatus"),
        col(out, "count_order"), col(out, "sum_charge"))}
    if got != want:
        raise AssertionError(f"{label} disagrees with numpy: {got} {want}")
    print(f"{label} equals numpy exactly: (count_order, sum_charge at scale "
          f"6) {sorted(want.values())}", flush=True)


def check_q15(out, tables, label):
    """Fails unless Q15's revenue0 equals `oracle_q15` over `tables`."""
    import numpy as np
    keys, revs = oracle_q15(tables)
    got_s, got_r = (c.data_host() for c in out.columns)
    o = np.argsort(got_s)
    if not (np.array_equal(got_s[o], keys) and np.array_equal(got_r[o], revs)):
        raise AssertionError(f"{label} disagrees with numpy")
    print(f"{label} equals numpy exactly: {len(keys)} groups", flush=True)


def oracle_mj1(t):
    """MJ1: (ps_suppkey, pairs, sum(l_quantity) at scale 2) by key: each
    part's lineitem count and quantity, over its 4 partsupp rows."""
    import numpy as np
    li, ps = t["lineitem"], t["partsupp"]
    part = col(li, "l_partkey")
    n_part = int(col(ps, "ps_partkey").max()) + 1
    cnt = np.bincount(part, minlength=n_part)
    qty = np.bincount(part, weights=col(li, "l_quantity"),
                      minlength=n_part).astype(np.int64)
    pp, sk = col(ps, "ps_partkey"), col(ps, "ps_suppkey")
    pairs = np.bincount(sk, weights=cnt[pp]).astype(np.int64)
    # every partial sum stays below 2^53, so float64 adds are exact
    total = np.bincount(sk, weights=qty[pp]).astype(np.int64)
    keys = np.flatnonzero(pairs)
    return keys, pairs[keys], total[keys]


def oracle_mb(t):
    """MB: (s_nationkey, lines, sum(l_extendedprice) at scale 2) by nation
    of each line's supplier."""
    import numpy as np
    li, su = t["lineitem"], t["supplier"]
    nation = np.zeros(int(col(su, "s_suppkey").max()) + 1, np.int64)
    nation[col(su, "s_suppkey")] = col(su, "s_nationkey")
    n = nation[col(li, "l_suppkey")]
    cnt = np.bincount(n)
    price = np.bincount(n, weights=col(li, "l_extendedprice")).astype(
        np.int64)
    keys = np.flatnonzero(cnt)
    return keys, cnt[keys], price[keys]


def mesh_run(ctx, sql, label, cls, route, expect, card, rows):
    """A mesh query's main path: launch counts set to 0, MESH_RUNS runs
    (the first cold), counts read. Fails unless the exec `cls` ran every
    time on `route` with no fallback and every kernel of `expect`
    launched. Returns (result, launches, ms of each run)."""
    from datafusion_tpu_torch import kernels
    kernels.reset_launch_counts()
    times = []
    for _ in range(MESH_RUNS):
        t0 = time.perf_counter()
        out = ctx.sql(sql).collect_batch()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.launch_counts()
    ex = find_exec(ctx.sql(sql).create_physical_plan(), cls)
    if ex is None or type(ex) is not cls or ex.fallbacks != 0:
        raise AssertionError(f"{label} did not run on the mesh: {ex}")
    if [r for r, _salt in ex.routes] != [route] * MESH_RUNS:
        raise AssertionError(f"{label}: routes {ex.routes}, not {route}")
    missing = [k for k in expect if launches[k] < 1]
    if missing:
        raise AssertionError(f"{label} did not launch {missing}")
    no_fallbacks(ctx, sql, label)
    per_query = {k: launches[k] / MESH_RUNS for k in expect}
    print(f"{label} on {MESH_SHARDS} shards ({ex.the_mesh().describe()}), "
          f"route {ex.routes[-1]}: cold {times[0]:.3f} ms, warm "
          f"{times[1]:.3f} / {times[2]:.3f} ms, "
          f"{rows / (min(times[1:]) / 1e3):.1f} rows/s, launches per query "
          f"{per_query}, fallbacks 0 [{card}]", flush=True)
    return out, launches, times


def mesh_breakdown(ctx, sql, card, label, cls, main):
    spans = breakdown(ctx, sql, card, label, cls, main=main)
    if spans:
        top = max(spans, key=spans.get)
        print(f"{label} largest host part: {top} {spans[top]} ms "
              f"(host clock, profiled run) [{card}]", flush=True)


def partition_vs_plain(ex, ctx, card):
    """K1 (`partition_rows`) against its plain version on MJ1's probe rows
    of shard 0 (one round at the exec's cap): equal send buffers, splits
    and flags; timed against the plain version and `torch.argsort` of the
    owners (stable), the library's yardstick."""
    import torch
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.exchange import (
        partition_rows, partition_rows_plain, shard_owner)
    from datafusion_tpu_torch.parallel.distributed import row_ranges
    from datafusion_tpu_torch.parallel.exchange import _lanes_of
    from datafusion_tpu_torch.physical.plan.base import collect_batch
    tctx = ctx.task_context()
    bb = collect_batch(ex.build_source, tctx)
    pb = collect_batch(ex.probe_source, tctx)
    jplan = ex._join_key_plan(bb, pb, ex.build_predicate, ex.probe_predicate,
                              True, True)
    pkey, pvalid = ex.packed_keys(pb, ex.probe_keys, jplan, 1, True)
    pools = ex._lower_packed(ex.build_predicate, ex.probe_predicate)[0]
    nb, npc = ex.n_build, len(ex.probe_source.schema())
    pcols = ex._columns(pb, [i for i in pools.columns
                             if nb <= i < nb + npc], nb, True)
    lo, hi = row_ranges(pb.num_rows, MESH_SHARDS)[0]
    lanes = [x[lo:hi] for x in _lanes_of(pcols)[0]]
    keys, pend0 = pkey[lo:hi], pvalid[lo:hi]
    cap = hi - lo
    before = kernels.launch_counts()["partition_rows"]
    got = partition_rows(keys, pend0.clone(), MESH_SHARDS, cap, lanes)
    if kernels.launch_counts()["partition_rows"] - before != 2:
        raise AssertionError("partition_rows: not the count and one sweep")
    want = partition_rows_plain(keys, pend0.clone(), MESH_SHARDS, cap, lanes)
    torch.cuda.synchronize()
    if got.splits != want.splits or not torch.equal(got.keys, want.keys) or \
            not all(torch.equal(a, b) for a, b in zip(got.lanes, want.lanes)):
        raise AssertionError("partition_rows differs from its plain version")
    pend = pend0.clone()

    def reset():
        pend.copy_(pend0)
    ms = cuda_ms(lambda: partition_rows(keys, pend, MESH_SHARDS, cap, lanes),
                 10, reset)
    plain_ms = cuda_ms(lambda: partition_rows_plain(
        keys, pend, MESH_SHARDS, cap, lanes), 3, reset)
    owner = shard_owner(keys, MESH_SHARDS)
    lib_ms = cuda_ms(lambda: torch.argsort(owner, stable=True), 5)
    n, m = hi - lo, sum(got.splits)
    lane_b = sum(x.element_size() for x in lanes)
    bnd = bound(n * (8 + 1 + lane_b) + n + m * (8 + lane_b), 0)
    print(f"partition_rows MJ1 SF10 probe, shard 0: {n} rows, {len(lanes)} "
          f"lanes, splits {got.splits}: kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, stable argsort of the owners {lib_ms:.6f} ms, "
          f"bound {bnd['bound_ms']:.6f} ms, equal [{card}]", flush=True)
    return entry(0, ms, plain_ms, bnd, lib_ms)


def record_merges(mods):
    """Replace `merge_partials` in each module of `mods` by a recorder that
    keeps each call (the function, its arguments and a copy of the tensors
    of its tables as they were before it), then makes the call; returns
    (the list of recorded calls, a function that puts the originals
    back). It takes any tree's signature: the tables come second."""
    import torch
    calls, origs = [], [(m, m.merge_partials) for m in mods]

    def recorder(orig):
        def call(*args, **kwargs):
            snap = {k: v.clone() for k, v in vars(args[1]).items()
                    if isinstance(v, torch.Tensor)}
            calls.append((orig, args, kwargs, snap))
            return orig(*args, **kwargs)
        return call
    for m, orig in origs:
        m.merge_partials = recorder(orig)
    return calls, lambda: [setattr(m, "merge_partials", o) for m, o in origs]


def merge_calls(ctx, sql, label):
    """The K2 calls of one warm run of the mesh query `sql` (its main
    path, recorded) and the launches that run made."""
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.parallel import distributed as D
    from datafusion_tpu_torch.parallel import exchange as X
    ctx.sql(sql).collect_batch()
    calls, restore = record_merges((D, X))
    try:
        before = kernels.launch_counts()["merge_partials"]
        ctx.sql(sql).collect_batch()
        launches = kernels.launch_counts()["merge_partials"] - before
    finally:
        restore()
    if not calls:
        raise AssertionError(f"{label} made no K2 call")
    return calls, launches


_L2_FLUSH = []


def flush_l2():
    """Evict the card's L2 (50 MB on the H100): 128 MiB written."""
    import torch
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(1 << 24, dtype=torch.int64,
                                     device=DEVICE))
    _L2_FLUSH[0].zero_()


def replay(call, fn=None):
    """(a function that makes the recorded call, or the same call of `fn`,
    on the current copy of its tables; a setup that makes a fresh copy as
    they were before the call, then flushes the L2, so a call finds its
    tables in HBM whatever their size; the list holding that copy)."""
    import copy
    orig, args, kwargs, snap = call
    held = []

    def setup():
        obj = copy.copy(args[1])
        for k, v in snap.items():
            setattr(obj, k, v.clone())
        held[:] = [obj]
        flush_l2()

    def run():
        return (fn or orig)(args[0], held[0], *args[2:], **kwargs)
    setup()
    return run, setup, held


def merge_vs_plain(calls, label, card):
    """K2 against its plain version on each recorded call of a query's
    main path (`merge_calls`): equal distinct-key counts, overflow flags
    and groups (compacted, by key) in every local table; each call timed
    (CUDA events, fresh tables each time, the L2 flushed) beside its plain
    version. Bound:
    each entry read once, each group's cells written once. Returns the
    query's entry, its calls' ms summed."""
    import numpy as np
    import torch
    from datafusion_tpu_torch.device.exchange import merge_partials_plain
    from datafusion_tpu_torch.device.groupby import compact_groups
    ms = plain_ms = 0.0
    nbytes = entries = 0
    parts = []
    for call in calls:
        run, setup, held = replay(call)
        run()
        got = held[0]
        prun, psetup, pheld = replay(call, merge_partials_plain)
        prun()
        want = pheld[0]
        torch.cuda.synchronize()
        if not (torch.equal(got.groups, want.groups) and
                torch.equal(got.overflow, want.overflow)):
            raise AssertionError(f"{label}: merge_partials counts differ")
        for a, b in zip(got.tables, want.tables):
            a, b = (compact_groups(t).cpu().numpy() for t in (a, b))
            a, b = a[:, np.argsort(a[0])], b[:, np.argsort(b[0])]
            if not np.array_equal(a, b):
                raise AssertionError(f"{label}: merge_partials differs "
                                     f"from its plain version")
            nbytes += a.size * 8
        t = cuda_ms(run, 20, setup)
        ms += t
        plain_ms += cuda_ms(prun, 3, psetup)
        srcs = call[1][0]
        nbytes += sum(e.numel() * 8 for e in srcs)
        entries += sum(e.shape[1] for e in srcs)
        parts.append(f"{len(srcs)} source(s) of {[e.shape[1] for e in srcs]}"
                     f" entries into {got.n} tables: {t:.6f} ms")
    bnd = bound(nbytes, 0)
    print(f"merge_partials {label}: {len(calls)} calls ({'; '.join(parts)})"
          f": kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
          f"{bnd['bound_ms']:.6f} ms, {entries} entries, equal [{card}]",
          flush=True)
    return entry(0, ms, plain_ms, bnd)


def merge_variant(label, ctx, sql, counts, card) -> dict:
    """The kernels line's entry of K2 on the mesh query `label`: its
    recorded calls held to the plain version and timed, the launches of
    its main path's runs (`counts`)."""
    from datafusion_tpu_torch.device.exchange import merge_partials_kernel
    k = merge_partials_kernel
    calls, _n = merge_calls(ctx, sql, f"{label} SF10")
    return dict(name=f"merge_partials[{label}]", route="cuda",
                source=k.source, replaces=k.replaces,
                launches=counts["merge_partials"],
                **merge_vs_plain(calls, f"{label} SF10", card))


def mesh_phase(sf10, tables, card, add, report):
    """The mesh on one card: `SET datafusion.tpu.mesh_devices = 4` makes
    LocalMesh(4) on the H100. MQ1 (Q1 over `make_lineitem`'s SF10 rows:
    the all_gather aggregate), MQ15 (Q15's revenue0: the owned-slot
    shuffle), MJ1 (lineitem x partsupp: the partitioned join) and MB
    (lineitem x supplier: the broadcast join) against numpy, each with 0
    fallbacks, its route, cold and warm times and a breakdown; K1 and K2
    against their plain versions (report["partition_rows"],
    report["merge_partials"]); then MQ1 once more through a one-rank NCCL
    ProcessGroupMesh, against the 4-shard rows. Returns the kernels
    line's entries of K2 on MQ1, MJ1 and MB."""
    import copy
    import numpy as np
    import torch
    import torch.distributed as dist
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.parallel import ProcessGroupMesh
    from datafusion_tpu_torch.parallel import exchange as X
    from datafusion_tpu_torch.physical.plan.distributed_aggregate import (
        TorchDistributedAggregateExec as Agg,
        TorchDistributedJoinAggregateExec as Join)
    dev = torch.device(DEVICE)
    q1ctx, ctx = dft.SessionContext(dev), dft.SessionContext(dev)
    for c in (q1ctx, ctx):
        c.config.set("datafusion.tpu.mesh_devices", MESH_SHARDS)
    q1ctx.register_table("lineitem", dft.MemTable(sf10.schema, [[sf10]]))
    for tname, b in tables.items():
        ctx.register_table(tname, dft.MemTable(b.schema, [[b]]))
    li = tables["lineitem"]
    agg = ["merge_partials", "compact_groups"]

    out, counts, _ = mesh_run(q1ctx, Q1, "MQ1 SF10", Agg,
                              "distributed_group_aggregate",
                              agg + ["fused_dense_aggregate"], card,
                              sf10.num_rows)
    add(counts)
    # K2: one launch for the 4 local shards of each merge step
    launched_as_predicted("MQ1 SF10", counts, {"merge_partials": 1},
                          MESH_RUNS)
    check_q1(out, sf10, "MQ1 SF10")
    mesh_breakdown(q1ctx, Q1, card, "MQ1 SF10", Agg, "aggregate_kernel")
    variants = [merge_variant("MQ1", q1ctx, Q1, counts, card)]

    X.ROUNDS.clear()
    out, counts, _ = mesh_run(ctx, Q15_SUB, "MQ15 SF10", Agg,
                              "distributed_shuffle_group_aggregate",
                              agg + ["hash_group_aggregate",
                                     "partition_rows"], card, li.num_rows)
    add(counts)
    # K1: the count and one sweep a call, a call a shard; K2 a round
    launched_as_predicted("MQ15 SF10", counts,
                          {"partition_rows": 2 * MESH_SHARDS,
                           "merge_partials": X.ROUNDS["shuffle"]},
                          MESH_RUNS)
    check_q15(out, tables, "MQ15 SF10")
    mesh_breakdown(ctx, Q15_SUB, card, "MQ15 SF10", Agg, "aggregate_kernel")
    calls, _n = merge_calls(ctx, Q15_SUB, "MQ15 SF10")
    report["merge_partials"] = merge_vs_plain(calls, "MQ15 SF10", card)

    ex = find_exec(ctx.sql(MJ1).create_physical_plan(), Join)
    if "ps_partkey" not in [f.name for f in ex.build_source.schema()]:
        raise AssertionError(f"MJ1 builds {ex.display_line()}")
    X.ROUNDS.clear()
    out, counts, _ = mesh_run(ctx, MJ1, "MJ1 SF10", Join,
                              "distributed_partitioned_join_aggregate",
                              agg + ["partition_rows", "join_build",
                                     "join_aggregate",
                                     "hash_group_aggregate"], card,
                              li.num_rows)
    add(counts)
    # K1 a shard for the build, the probe and the partial tables; K2 a
    # round of the partial tables' shuffle (or their one all_gather)
    launched_as_predicted("MJ1 SF10", counts,
                          {"partition_rows": 2 * 3 * MESH_SHARDS,
                           "merge_partials": X.ROUNDS.get("shuffle", 1)},
                          MESH_RUNS)
    want = oracle_mj1(tables)
    got = [c.data_host() for c in out.columns]
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("MJ1 SF10 disagrees with numpy")
    print(f"MJ1 SF10 equals numpy exactly: {len(want[0])} suppliers, "
          f"{int(want[1].sum())} pairs", flush=True)
    mesh_breakdown(ctx, MJ1, card, "MJ1 SF10", Join, "join_aggregate")
    report["partition_rows"] = partition_vs_plain(ex, ctx, card)
    del ex
    variants.append(merge_variant("MJ1", ctx, MJ1, counts, card))

    mb = MB
    ex = find_exec(ctx.sql(mb).create_physical_plan(), Join)
    if "s_suppkey" not in [f.name for f in ex.build_source.schema()]:
        mb = mb.replace("FROM lineitem JOIN supplier",
                        "FROM supplier JOIN lineitem")
    out, counts, _ = mesh_run(ctx, mb, "MB SF10", Join,
                              "distributed_join_group_aggregate",
                              agg + ["join_build", "join_aggregate"], card,
                              li.num_rows)
    add(counts)
    launched_as_predicted("MB SF10", counts, {"merge_partials": 1},
                          MESH_RUNS)
    want = oracle_mb(tables)
    got = [c.data_host() for c in out.columns]
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("MB SF10 disagrees with numpy")
    print(f"MB SF10 equals numpy exactly: {len(want[0])} nations, "
          f"{int(want[1].sum())} lines", flush=True)
    mesh_breakdown(ctx, mb, card, "MB SF10", Join, "join_aggregate")
    variants.append(merge_variant("MB", ctx, mb, counts, card))

    # MQ1 through a one-rank NCCL process group: the collectives of a
    # ProcessGroupMesh launch on the card
    rendezvous = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "datafusion_tpu_torch", "_build",
                              "nccl_rendezvous")
    os.makedirs(os.path.dirname(rendezvous), exist_ok=True)
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}",
                            rank=0, world_size=1)
    try:
        pmesh = ProcessGroupMesh()
        one = copy.copy(find_exec(q1ctx.sql(Q1).create_physical_plan(), Agg))
        one.mesh_devices, one.mesh, one.routes = 1, pmesh, []
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        (b1,) = list(one.execute(0, q1ctx.task_context()))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        add(counts)
        names = [f.name for f in b1.schema]
        rows1 = sorted(zip(*[c.to_pylist() for c in b1.columns]))
        (b4,) = list(find_exec(q1ctx.sql(Q1).create_physical_plan(),
                               Agg).execute(0, q1ctx.task_context()))
        rows4 = sorted(zip(*[c.to_pylist() for c in b4.columns]))
        if rows1 != rows4 or one.fallbacks or \
                one.routes != [("distributed_group_aggregate", 1)] or \
                counts["merge_partials"] < 1:
            raise AssertionError(f"MQ1 over NCCL: {rows1} {one.routes}")
        print(f"MQ1 SF10 over a one-rank NCCL ProcessGroupMesh "
              f"({pmesh.describe()}): {ms:.3f} ms, equals the 4-shard rows "
              f"({len(rows1)} groups of {len(names)} columns), launches "
              f"{ {k: v for k, v in counts.items() if v} } [{card}]",
              flush=True)
    finally:
        dist.destroy_process_group()
        if os.path.exists(rendezvous):
            os.remove(rendezvous)
    del q1ctx, ctx
    return variants


def clickbench_q10_q30(ctx, hb, card, add):
    """ClickBench Q10 (count(DISTINCT UserID) beside a sum, an avg and the
    count that the fused top-k orders by, over 5,000 RegionIDs) and Q30
    (90 sums: 180 lanes in 6 passes) at 99,997,497 rows: the distinct fold
    and the dense fold's passes against their plain versions, then both
    end to end against numpy with 0 fallbacks and a breakdown. Returns the
    kernels line's `hash_group_aggregate[distinct]` and
    `fused_dense_aggregate[passes]` entries, with their kernel's launches
    in each query's main-path run."""
    import numpy as np
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.groupby import TOPK_LAUNCHES
    k10, pairs, set_bytes = distinct_vs_plain(
        ctx, CB_Q10.split(" ORDER BY")[0], "CB Q10", card)
    out, counts10, _ = run_path(ctx, CB_Q10, [
        "hash_group_aggregate", "group_topk", "compact_groups"], card,
        "CB Q10", HITS_ROWS)
    add(counts10)
    launched_as_predicted("CB Q10", counts10, {"hash_group_aggregate": 1,
                                               "group_topk": TOPK_LAUNCHES})
    region, user = col(hb, "RegionID"), col(hb, "UserID")
    adv, width = col(hb, "AdvEngineID"), col(hb, "ResolutionWidth")
    n_reg = int(region.max()) + 1
    per = np.bincount(region, minlength=n_reg)
    top_counts_agree("CB Q10", col(out, "RegionID"), col(out, "c"),
                     np.arange(n_reg), per)
    uniq = np.unique(region * (int(user.max()) + 1) + user)
    users = np.bincount(uniq // (int(user.max()) + 1), minlength=n_reg)
    sums = np.bincount(region, weights=adv, minlength=n_reg)
    wsum = np.bincount(region, weights=width, minlength=n_reg)
    for i, r in enumerate(col(out, "RegionID")):
        got = [int(out.columns[1].data_host()[i]),
               float(out.columns[3].data_host()[i]),
               int(out.columns[4].data_host()[i])]
        if got[0] != int(sums[r]) or got[2] != int(users[r]) or \
                abs(got[1] - wsum[r] / per[r]) > 1e-9 * wsum[r] / per[r]:
            raise AssertionError(f"CB Q10 region {r}: {got} != "
                                 f"{[sums[r], wsum[r] / per[r], users[r]]}")
    print(f"CB Q10 equals numpy: top counts {col(out, 'c').tolist()}, "
          f"{len(uniq)} distinct (RegionID, UserID) pairs ({pairs} in the "
          f"kernel's set of {set_bytes} bytes), avg within rel 1e-9",
          flush=True)
    breakdown(ctx, CB_Q10, card, "CB Q10")
    del uniq
    k30 = kernel_vs_plain(ctx, CB_Q30, "hits", None, reps=(3, 1))
    print(f"fused_dense_aggregate CB Q30 (180 lanes, 6 passes, G = 1): "
          f"kernel {k30['ms']:.6f} ms, plain {k30['plain_ms']:.6f} ms, "
          f"bound {k30['bound_ms']:.6f} ms ({k30['bound_by']}), "
          f"max_abs_err {k30['max_abs_err']} [{card}]", flush=True)
    out, counts30, _ = run_path(ctx, CB_Q30, ["fused_dense_aggregate"], card,
                                "CB Q30", HITS_ROWS)
    add(counts30)
    launched_as_predicted("CB Q30", counts30, {"fused_dense_aggregate": 6})
    total = int(width.sum())
    want = [total + i * HITS_ROWS for i in range(90)]
    got = [int(c.data_host()[0]) for c in out.columns]
    if got != want:
        raise AssertionError(f"CB Q30 disagrees with numpy: {got[:3]} "
                             f"{want[:3]}")
    print(f"CB Q30 equals numpy exactly: 90 sums from {want[0]}, "
          f"fused_dense_aggregate launched "
          f"{counts30['fused_dense_aggregate']} times in {REPS + 1} runs "
          f"(6 passes of at most 32 lanes) [{card}]", flush=True)
    breakdown(ctx, CB_Q30, card, "CB Q30")
    fold = "datafusion_tpu/device/groupby.py"
    return [dict(name="hash_group_aggregate[distinct]", route="cuda",
                 source=kernels.KERNELS["hash_group_aggregate"].source,
                 replaces=f"{fold}:214",
                 launches=counts10["hash_group_aggregate"], **k10),
            dict(name="fused_dense_aggregate[passes]", route="cuda",
                 source=kernels.KERNELS["fused_dense_aggregate"].source,
                 replaces="datafusion_tpu/physical/plan/"
                          "device_aggregate.py:679",
                 launches=counts30["fused_dense_aggregate"], **k30)]


# The entry points a user starts the port with: the command line (a table
# made by SQL, since the GPU machine has no pyarrow to read a file), the
# bench runner at its own default SF 0.1, TPC-H's 22 queries on the card
# against the CPU, plan interchange and the multi-process pod
ENTRY_ROWS = 10_000_000
ENTRY_SF = 0.1
ENTRY_SELECT = ("SELECT g, count(*) AS c, sum(v) AS s FROM t GROUP BY g "
                "ORDER BY g")
ROUND_TRIPS = (1, 3, 5, 6, 10, 18)
# where the port raises as the JAX package does (`tests/test_torch_proto.py`
# and `test_torch_substrait.py` hold it there): Q18's IN subquery has no
# Substrait form and no logical JSON (its optimized plan, a semi join, is
# shipped instead), and a physical plan ships no join
IN_SUBQUERY = {18}
PHYSICAL_RAISES = {3, 5, 10, 18}
# tests/test_pod.py:50-55, over its 5,000-row table (seed 3)
POD_SQL = ("SELECT g, sum(v) sv, count(*) c, avg(f) af FROM t GROUP BY g "
           "ORDER BY g",
           "SELECT s, min(v) mn, max(v) mx FROM t WHERE v % 2 = 0 GROUP BY s "
           "ORDER BY s")


def same_result(got, want, ordered, label, rel=1e-9):
    """Equal rows (in order when `ordered`): floats within `rel`, every
    other value exactly."""
    import math
    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)} != {list(want)}")
    g, w = list(zip(*got.values())), list(zip(*want.values()))
    if not ordered:
        def key(r):
            return tuple((x is None, str(x)) for x in r)
        g, w = sorted(g, key=key), sorted(w, key=key)

    def same(a, b):
        if isinstance(a, float) and isinstance(b, float):
            return math.isclose(a, b, rel_tol=rel, abs_tol=1e-12) or (
                math.isnan(a) and math.isnan(b))
        return a == b and type(a) is type(b)
    if len(g) != len(w) or not all(
            all(same(a, b) for a, b in zip(rg, rw)) for rg, rw in zip(g, w)):
        raise AssertionError(f"{label} disagrees:\n{got}\n{want}")


def device_args(dev):
    """The port's commands take the card by default; only another device
    is named."""
    return [] if dev.type == "cuda" else ["--device", dev.type]


def entry_points_phase(dev, card, rows=ENTRY_ROWS, sf=ENTRY_SF):
    """The command line and the bench runner, each in a process of its own
    started first, then in this process TPC-H's 22 queries on `dev` against
    the CPU, the logical JSON, Substrait and physical round trips, and the
    2-worker pod; each part's seconds."""
    import numpy as np
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.api.dataframe import DataFrame
    from datafusion_tpu_torch.common.errors import NotImplementedError_
    from datafusion_tpu_torch.common.errors import PlanError
    from datafusion_tpu_torch.parallel.pod import LocalPod
    from datafusion_tpu_torch.physical.plan.base import collect_batch
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchDeviceExec)
    from datafusion_tpu_torch.proto import plan_from_json, plan_to_json
    from datafusion_tpu_torch.proto.physical import (phys_from_dict,
                                                     phys_to_dict)
    from datafusion_tpu_torch.substrait import (plan_to_substrait,
                                                substrait_to_plan)
    from datafusion_tpu_torch.tpch import QUERIES, register_tpch
    root = os.path.dirname(os.path.abspath(__file__))
    if rows % 8:
        raise ValueError("the CLI's table needs a multiple of 8 rows")
    create = ("CREATE TABLE t AS SELECT value % 8 AS g, value AS v FROM "
              f"generate_series(1, {rows})")
    commands = {
        "the CLI": [sys.executable, "-m", "datafusion_tpu_torch", "--format",
                    "csv"] + device_args(dev) + [
                        "-c", create, "-c", ENTRY_SELECT,
                        "-c", "EXPLAIN " + ENTRY_SELECT],
        "the bench runner": [
            sys.executable, "-m", "datafusion_tpu_torch.bench_runner",
            "tpch", "--sf", str(sf), "--iterations", "1"] + device_args(dev)}
    procs, seconds, done, waiters = {}, {}, {}, []

    def finish(label, proc, t0):
        # a thread a command: its output read as it comes, its end timed
        out, err = proc.communicate()
        done[label] = (time.perf_counter() - t0, out, err)

    try:
        for label, argv in commands.items():
            procs[label] = subprocess.Popen(
                argv, cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            waiters.append(threading.Thread(
                target=finish, args=(label, procs[label],
                                     time.perf_counter()), daemon=True))
            waiters[-1].start()

        # -- TPC-H's 22 queries on the card against the CPU ---------------
        t0 = time.perf_counter()
        ctx = dft.SessionContext(dev)
        register_tpch(ctx, sf=sf)
        host = dft.SessionContext("cpu")
        for name in ctx.tables:
            host.register_table(name, ctx.get_table(name))
        kernels.reset_launch_counts()
        ran, fell = [], []
        for q in sorted(QUERIES):
            sql = QUERIES[q]
            same_result(ctx.sql(sql).to_pydict(), host.sql(sql).to_pydict(),
                        "order by" in sql.lower(), f"TPC-H Q{q} SF {sf}")
            execs = [n for n in walk_execs(ctx.sql(sql).create_physical_plan())
                     if isinstance(n, TorchDeviceExec)]
            (fell if any(n.fallbacks for n in execs) else
             ran if execs else []).append(q)
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        if dev.type == "cuda" and not launched:
            raise AssertionError(f"TPC-H SF {sf} launched no kernel")
        seconds["TPC-H"] = time.perf_counter() - t0
        print(f"TPC-H Q1-Q22 SF {sf}: {dev.type} equals cpu (floats within "
              f"rel 1e-9); device execs with no fallback in Q{ran}, the "
              f"host plan taken (fallbacks) in Q{fell}; kernels launched "
              f"{launched}", flush=True)

        # -- plan interchange on the card ---------------------------------
        t0 = time.perf_counter()
        names = LocalPod._table_names(ctx)
        for q in ROUND_TRIPS:
            sql, label = QUERIES[q], f"Q{q} SF {sf}"
            frame = ctx.sql(sql)
            want = frame.to_pydict()
            ordered = "order by" in sql.lower()
            try:
                js, kind = plan_to_json(frame.plan), "plan"
            except PlanError:
                if q not in IN_SUBQUERY:
                    raise
                js, kind = plan_to_json(frame.optimized_plan()), "optimized"
            same_result(DataFrame(ctx, plan_from_json(js, ctx)).to_pydict(),
                        want, ordered, f"{label} logical JSON")
            try:
                proto = json.loads(json.dumps(
                    plan_to_substrait(frame.logical_plan())))
            except NotImplementedError_ as e:
                if q not in IN_SUBQUERY:
                    raise
                sub = f"raises NotImplementedError_ ({e})"
            else:
                if q in IN_SUBQUERY:
                    raise AssertionError(f"{label}: Substrait did not raise")
                same_result(DataFrame(ctx, substrait_to_plan(proto, ctx))
                            .to_pydict(), want, ordered,
                            f"{label} Substrait")
                sub = "same rows"
            plan = frame.create_physical_plan()
            fused = sorted({type(n).__name__ for n in walk_execs(plan)
                            if isinstance(n, TorchDeviceExec)})
            try:
                d = json.loads(json.dumps(phys_to_dict(plan, names)))
            except NotImplementedError as e:
                if q not in PHYSICAL_RAISES:
                    raise
                phys = f"raises NotImplementedError ({e})"
            else:
                if q in PHYSICAL_RAISES:
                    raise AssertionError(f"{label}: the physical plan "
                                         f"shipped")
                back = phys_from_dict(d, ctx)
                if "Torch" in json.dumps(d) or any(
                        isinstance(n, TorchDeviceExec)
                        for n in walk_execs(back)):
                    raise AssertionError(f"{label}: a device exec shipped")
                same_result(collect_batch(back, ctx.task_context())
                            .to_pydict(), want, ordered,
                            f"{label} physical dict")
                phys = "same rows; the dict holds no device exec"
            print(f"{label} ({', '.join(fused)} on {dev.type}): logical JSON "
                  f"({kind}) same rows; Substrait {sub}; physical {phys}",
                  flush=True)
        seconds["proto and Substrait"] = time.perf_counter() - t0

        # -- the pod: 2 worker processes on the card ----------------------
        t0 = time.perf_counter()
        rng = np.random.default_rng(3)
        n = 5000
        ctx.register_arrays("t", {
            "g": rng.integers(0, 7, n),
            "s": np.array([f"k{i % 3}" for i in range(n)]),
            "v": rng.integers(0, 100, n).astype(np.int64),
            "f": rng.random(n)})
        lineitem = ctx.sql("SELECT * FROM lineitem").collect_batch()
        pod_kwargs = {} if dev.type == "cuda" else {"device": dev.type}
        with LocalPod(2, **pod_kwargs) as pod:
            pod.register_sharded("lineitem", lineitem)
            pod.register_sharded("t", ctx.sql("SELECT * FROM t")
                                 .collect_batch())
            for label, sql in (("Q1", QUERIES[1]), ("pod SQL 1", POD_SQL[0]),
                               ("pod SQL 2", POD_SQL[1])):
                same_result(pod.sql_distributed(ctx, sql).to_pydict(),
                            ctx.sql(sql).to_pydict(), True,
                            f"the pod's {label}", rel=1e-12)
        seconds["the pod"] = time.perf_counter() - t0
        print(f"the pod (2 workers on {dev.type}, lineitem SF {sf} "
              f"{lineitem.num_rows} rows sharded): Q1 and test_pod.py's two "
              f"SQL texts equal the single process (floats within rel "
              f"1e-12)", flush=True)
        del ctx, host, lineitem

        # -- the two commands ---------------------------------------------
        outs = {}
        for waiter in waiters:
            waiter.join(timeout=900)
        for label, proc in procs.items():
            if label not in done:
                raise AssertionError(f"{label} did not end in 900 s")
            seconds[label], outs[label], err = done[label]
            if proc.returncode:
                raise AssertionError(f"{label} exited {proc.returncode}:\n"
                                     f"{err[-4000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    m = rows // 8
    want = ["g,c,s"] + [f"{g},{m},{8 * m * (m + 1) // 2}" if g == 0 else
                        f"{g},{m},{8 * m * (m - 1) // 2 + g * m}"
                        for g in range(8)]
    lines = outs["the CLI"].splitlines()
    if "g,c,s" not in lines or \
            lines[lines.index("g,c,s"):][:9] != want:
        raise AssertionError(f"the CLI's CSV is not the closed form:\n"
                             f"{outs['the CLI']}")
    shown = f"TorchGroupAggregateExec: gby=[g], aggr=[count(*), sum(t.v)], " \
            f"device={dev.type}"
    if shown not in outs["the CLI"]:
        raise AssertionError(f"the CLI's plan does not show {shown}:\n"
                             f"{outs['the CLI']}")
    print(f"the CLI (python -m datafusion_tpu_torch --format csv): "
          f"{rows} rows made by CREATE TABLE ... AS, the grouped count and "
          f"sum equal the closed form, EXPLAIN shows {shown}", flush=True)
    summary = json.loads(outs["the bench runner"].strip().splitlines()[-1])
    if summary.get("suite") != "tpch" or \
            list(summary["ms"]) != [f"q{i}" for i in range(1, 23)]:
        raise AssertionError(f"the bench runner's line: {summary}")
    print(f"the bench runner (tpch --sf {sf} --iterations 1) ms: "
          f"{json.dumps(summary['ms'])}", flush=True)
    for label, secs in seconds.items():
        print(f"entry points: {label} {secs:.1f} s [{card}]", flush=True)


def walk_execs(plan):
    yield plan
    for c in plan.children():
        yield from walk_execs(c)


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
    from datafusion_tpu_torch.device.groupby import TOPK_LAUNCHES
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec, TorchJoinChainRowsExec)
    # registers join_build and join_aggregate with the launch counts
    from datafusion_tpu_torch.physical.plan.device_join_agg import (  # noqa
        TorchJoinAggregateExec)
    # registers partition_rows and merge_partials
    from datafusion_tpu_torch.physical.plan.distributed_aggregate import (  # noqa
        TorchDistributedAggregateExec)
    from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH

    card = smi()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    def phase(label):
        print(f"-- {time.perf_counter() - t_start:.1f} s: {label}",
              flush=True)

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
    phase("dense path: Q1 and Q6")
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
    check_q1(out, sf10, "Q1 SF10")

    q6 = kernel_vs_plain(ctx, Q6, "lineitem", None)
    print(f"fused_dense_aggregate Q6 SF10 (G = 1): kernel {q6['ms']:.6f} ms, "
          f"plain {q6['plain_ms']:.6f} ms, bound {q6['bound_ms']:.6f} ms, "
          f"max_abs_err {q6['max_abs_err']} [{card}]", flush=True)
    out, counts, _ = run_path(ctx, Q6, ["fused_dense_aggregate"], card,
                              "Q6 SF10", SF10_ROWS)
    add(counts)
    ship, qty, price, disc = (col(sf10, c) for c in (
        "l_shipdate", "l_quantity", "l_extendedprice", "l_discount"))
    m = ((ship >= days(1994, 1, 1)) & (ship < days(1995, 1, 1)) &
         (disc / 100.0 >= 0.05) & (disc / 100.0 <= 0.07) & (qty < 2400))
    want_q6 = int((price[m] * disc[m]).sum())
    if int(out.columns[0].data_host()[0]) != want_q6:
        raise AssertionError(f"Q6 SF10: {out.columns[0].data_host()} != "
                             f"{want_q6}")
    print(f"Q6 SF10 revenue equals numpy exactly: {want_q6} (scale 4), "
          f"{int(m.sum())} rows pass", flush=True)
    del ctx, ship, qty, price, disc, m

    # == TPC-H SF10: hash path (Q18's and Q15's subqueries) ==================
    phase("TPC-H SF10: hash path (Q18's and Q15's subqueries)")
    t0 = time.perf_counter()
    tables = tpch_tables(10, seed=0)
    li = tables["lineitem"]
    print(f"TPC-H SF10: " + ", ".join(
        f"{k} {v.num_rows}" for k, v in tables.items()) +
        f" rows made in {time.perf_counter() - t0:.3f} s", flush=True)
    ctx = dft.SessionContext(dev)
    for tname, b in tables.items():
        ctx.register_table(tname, dft.MemTable(b.schema, [[b]]))
    k2, k3, kc, table, _s, _n = hash_kernel_vs_plain(
        ctx, Q18_SUB, "Q18 sub SF10", card, having=True)
    del table
    report["hash_group_aggregate"] = k2
    report["compact_groups"] = kc
    _k2, _k3, _kc, table, _s, _n = hash_kernel_vs_plain(ctx, Q15_SUB,
                                                   "Q15 sub SF10", card)
    del table

    ok_, qty = (col(li, c) for c in ("l_orderkey", "l_quantity"))
    out, counts, _ = run_path(ctx, Q18_SUB, ["hash_group_aggregate",
                                             "compact_groups"],
                              card, "Q18 sub SF10", li.num_rows)
    add(counts)
    # the mark pass and the copy of the 676 groups kept
    launched_as_predicted("Q18 sub SF10", counts, {"compact_groups": 2})
    having_row = dict(name="compact_groups[Q18 sub HAVING]", route="cuda",
                      source="datafusion_tpu_torch/csrc/compact_groups.cu",
                      replaces="datafusion_tpu/physical/plan/"
                               "device_aggregate.py:1279",
                      launches=counts["compact_groups"], **k3)
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
    check_q15(out, tables, "Q15 sub SF10")
    breakdown(ctx, Q15_SUB, card, "Q15 sub SF10")
    del ok_, qty, starts, sums

    # == TPC-H SF10: join chains (Q3, Q4, Q5) =================================
    phase("TPC-H SF10: join chains (Q3, Q4, Q5)")
    chain = ["chain_build", "chain_aggregate"]
    tctx = ctx.task_context()
    stage = {}         # query -> the staging kernels its run launches
    builds = {}        # query -> chain_build's launches a cold run
    for q in (5, 3, 4):
        ex = find_exec(ctx.sql(TPCH[q]).create_physical_plan(),
                       TorchJoinChainAggregateExec)
        if ex is None:
            raise AssertionError(f"Q{q} plans no TorchJoinChainAggregateExec")
        print(f"Q{q} SF10 plans {ex.display_line()}", flush=True)
        stage[q] = staging_kernels(ex, tctx, q)
        kb, builds[q] = chain_builds_vs_plain(ex, tctx, card, f"Q{q} SF10")
        kw = chain_walk_vs_plain(ex, tctx, card, f"Q{q} SF10")
        if q == 5:
            report["chain_build"], report["chain_aggregate"] = kb, kw
            kc, kf = compose_vs_plain(ex, tctx, card, "Q5 SF10")
            if kc is None or kf is None:
                raise AssertionError("Q5 SF10 composed or folded nothing")
            report["chain_compose"], report["chain_fold"] = kc, kf
    torch.cuda.empty_cache()

    out, counts, _ = run_path(ctx, TPCH[3], chain + ["compact_groups",
                                                     "chain_mask"] +
                              stage[3], card,
                              "Q3 SF10", li.num_rows,
                              TorchJoinChainAggregateExec, cold=cold_staging(
                                  ctx, TPCH[3], tctx, "Q3 SF10", builds[3]))
    add(counts)
    launched_as_predicted("Q3 SF10", counts, {
        "chain_aggregate": WALK_LAUNCHES["Q3 SF10"]})
    print(f"Q3 SF10 {check_q3(out, tables, 'Q3 SF10')}", flush=True)
    breakdown(ctx, TPCH[3], card, "Q3 SF10", TorchJoinChainAggregateExec)

    out, counts, _ = run_path(ctx, TPCH[4], chain + ["compact_groups"] +
                              stage[4], card, "Q4 SF10",
                              tables["orders"].num_rows,
                              TorchJoinChainAggregateExec, cold=cold_staging(
                                  ctx, TPCH[4], tctx, "Q4 SF10", builds[4]))
    add(counts)
    launched_as_predicted("Q4 SF10", counts, {
        "chain_aggregate": WALK_LAUNCHES["Q4 SF10"]})
    prios, want4 = oracle_q4(tables)
    got4 = out.to_pydict()
    if got4 != {"o_orderpriority": prios, "order_count": want4.tolist()}:
        raise AssertionError(f"Q4 SF10 disagrees with numpy: {got4} "
                             f"{prios} {want4}")
    print(f"Q4 SF10 equals numpy exactly: {want4.tolist()}", flush=True)
    breakdown(ctx, TPCH[4], card, "Q4 SF10", TorchJoinChainAggregateExec)

    out, counts, _ = run_path(ctx, TPCH[5], chain + ["compact_groups"] +
                              stage[5], card, "Q5 SF10",
                              li.num_rows, TorchJoinChainAggregateExec,
                              cold=cold_staging(
                                  ctx, TPCH[5], tctx, "Q5 SF10", builds[5]))
    add(counts)
    launched_as_predicted("Q5 SF10", counts, {
        "chain_aggregate": WALK_LAUNCHES["Q5 SF10"]})
    want5 = oracle_q5(tables)
    got5 = list(zip(out.columns[0].to_pylist(),
                    col(out, "revenue").tolist()))
    if got5 != want5:
        raise AssertionError(f"Q5 SF10 disagrees with numpy: {got5} {want5}")
    print(f"Q5 SF10 equals numpy exactly: {got5}", flush=True)
    breakdown(ctx, TPCH[5], card, "Q5 SF10", TorchJoinChainAggregateExec)
    del ex, out
    torch.cuda.empty_cache()

    # == TPC-H SF10: row-returning join chains (Q2, Q20) ======================
    phase("TPC-H SF10: row-returning join chains (Q2, Q20)")
    ex2 = find_exec(ctx.sql(TPCH[2]).create_physical_plan(),
                    TorchJoinChainRowsExec)
    ex20 = find_exec(ctx.sql(TPCH[20]).create_physical_plan(),
                     TorchJoinChainRowsExec)
    if ex2 is None or ex20 is None:
        raise AssertionError("Q2 or Q20 plans no TorchJoinChainRowsExec")
    for q, ex in ((2, ex2), (20, ex20)):
        print(f"Q{q} SF10 plans {ex.display_line()}", flush=True)
        stage[q] = staging_kernels(ex, tctx, q)
    report["chain_rows"], _kept = rows_vs_plain(ex2, tctx, card, "Q2 SF10")
    rows_vs_plain(ex20, tctx, card, "Q20 SF10 (inner chain)")
    report["group_emit"], _ng = emit_vs_plain(ctx, TPCH[20], card,
                                              "Q20 SF10")
    del ex2, ex20
    torch.cuda.empty_cache()

    out, counts, _ = run_path(ctx, TPCH[2], chain + stage[2] + [
                                  "compact_groups", "chain_rows"],
                              card, "Q2 SF10", tables["partsupp"].num_rows,
                              TorchJoinChainRowsExec,
                              cold=cold_staging(ctx, TPCH[2], tctx, "Q2 SF10"))
    add(counts)
    no_fallbacks(ctx, TPCH[2], "Q2 SF10")
    want2, n2 = oracle_q2(tables)
    got2 = {c: out.column_by_name(c).to_pylist()
            if out.column_by_name(c).dictionary is not None
            else col(out, c).tolist() for c in want2}
    if got2 != want2:
        raise AssertionError(f"Q2 SF10 disagrees with numpy:\n{got2}\n"
                             f"{want2}")
    print(f"Q2 SF10 equals numpy exactly: {n2} rows at their part's least "
          f"EUROPE cost, the first {len(want2['s_name'])} by balance "
          f"{want2['s_acctbal'][:3]}... (scale 2)", flush=True)
    breakdown(ctx, TPCH[2], card, "Q2 SF10", TorchJoinChainRowsExec,
              main="rows_walk")

    out, counts, _ = run_path(ctx, TPCH[20], [
        "hash_group_aggregate", "compact_groups", "group_emit",
        "chain_build", "chain_rows"] + stage[20], card, "Q20 SF10",
        li.num_rows, TorchJoinChainRowsExec,
        cold=cold_staging(ctx, TPCH[20], tctx, "Q20 SF10"))
    add(counts)
    no_fallbacks(ctx, TPCH[20], "Q20 SF10")
    agg = find_exec(ctx.sql(TPCH[20]).create_physical_plan(),
                    TorchGroupAggregateExec)
    if agg.resident_emits < 1:
        raise AssertionError("Q20 SF10: the aggregate left the card")
    want20, groups20 = oracle_q20(tables)
    got20 = {c: out.column_by_name(c).to_pylist() for c in want20}
    if got20 != want20:
        raise AssertionError(f"Q20 SF10 disagrees with numpy:\n{got20}\n"
                             f"{want20}")
    print(f"Q20 SF10 equals numpy exactly: {len(want20['s_name'])} "
          f"suppliers; the aggregate's {groups20} groups stayed on the card "
          f"({agg.resident_emits} resident emits)", flush=True)
    breakdown(ctx, TPCH[20], card, "Q20 SF10", TorchJoinChainRowsExec,
              main="rows_walk")
    del tctx, out, agg
    torch.cuda.empty_cache()

    # == TPC-H SF10: Q7-Q10, Q12, Q14, Q18, Q21 ===============================
    phase("TPC-H SF10: Q7-Q10, Q12, Q14, Q18, Q21")
    variants = [having_row] + full_lowering_phase(ctx, tables, card, add)

    # == TPC-H SF10: the fanout-N join-aggregate (J1, J2), Q5D ===============
    phase("TPC-H SF10: the fanout-N join-aggregate (J1, J2), Q5D")
    variants += join_agg_phase(ctx, tables, card, add, report)

    # == the chain's cross-query caches and the MemoryPool ====================
    phase("TPC-H SF10: the chain's caches and the MemoryPool (Q5, Q3's "
          "segments, Q5's regions, Q2, Q21, J1)")
    report["chain_mask"] = cache_phase(ctx, tables, card)
    torch.cuda.empty_cache()

    # == mesh: 4 shards on one H100 ==========================================
    phase("mesh: 4 shards on one H100 (MQ1, MQ15, MJ1, MB; MQ1 over NCCL)")
    variants += mesh_phase(sf10, tables, card, add, report)
    del sf10
    torch.cuda.empty_cache()

    # == TPC-H SF10: window functions (W1, W2, W3) ============================
    phase("TPC-H SF10: window functions (W1, W2, W3)")
    from datafusion_tpu_torch.physical.plan.window import WindowExec
    window = ["radix_sort", "gather_lanes", "window_scan"]
    n_li = li.num_rows
    scans = {}
    for label, sql in (("W1", W1), ("W2", W2), ("W3", W3)):
        (kg, ks), gathers, scans[label] = window_kernels_vs_plain(
            ctx, sql, card, f"{label} SF10")
        if label == "W1":
            report["gather_lanes"], report["window_scan"] = kg, ks
            w1_gathers = gathers

    out, counts, _ = run_path(ctx, W1, window, card, "W1 SF10", n_li,
                              WindowExec, reps=WINDOW_REPS, warm=False)
    add(counts)
    launched_as_predicted("W1 SF10", counts, {"gather_lanes": w1_gathers,
                                              "window_scan": scans["W1"]},
                          runs=WINDOW_REPS)
    want = oracle_w1(li)
    got = [col(out, c).astype(np.int64) for c in (
        "l_suppkey", "l_orderkey", "l_extendedprice", "rk", "order_qty")]
    if not same_rows(got, want):
        raise AssertionError("W1 SF10 disagrees with numpy")
    print(f"W1 SF10 equals numpy exactly: {out.num_rows} rows of rank <= 3 "
          f"over {len(np.unique(want[0]))} suppliers", flush=True)
    del out, got, want

    out, counts, _ = run_path(ctx, W2, window, card, "W2 SF10", n_li,
                              WindowExec, reps=WINDOW_REPS, warm=False)
    add(counts)
    launched_as_predicted("W2 SF10", counts, {"window_scan": scans["W2"]},
                          runs=WINDOW_REPS)
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
    del out, order, price, prev

    out, counts, _ = run_path(ctx, W3, window, card, "W3 SF10", n_li,
                              WindowExec, reps=WINDOW_REPS, warm=False)
    add(counts)
    launched_as_predicted("W3 SF10", counts, {"window_scan": scans["W3"]},
                          runs=WINDOW_REPS)
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
    del ctx, tables, li, out, order, flag, sums, idx, lo, qty7
    torch.cuda.empty_cache()

    # == hash path: ClickBench Q16 and Q17 at 99,997,497 rows ================
    phase("hash path: ClickBench Q16 and Q17 at 99,997,497 rows")
    t0 = time.perf_counter()
    hb = hits(HITS_ROWS, seed=0)
    print(f"hits: {HITS_ROWS} rows of UserID, SearchPhrase, EventTime, "
          f"RegionID, AdvEngineID, ResolutionWidth made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    ctx = dft.SessionContext(dev)
    ctx.register_table("hits", dft.MemTable(hb.schema, [[hb]]))
    k16, _k3, _kc, table, _spec, names = hash_kernel_vs_plain(
        ctx, CB_Q16.split(" ORDER BY")[0], "CB Q16 SF100M", card,
        library=True)
    report["group_topk"], _n = topk_vs_plain(table, names[0], names, card,
                                             "CB Q16")
    del table
    k17, _k3, _kc, table, _spec, names = hash_kernel_vs_plain(
        ctx, CB_Q17.split(" ORDER BY")[0], "CB Q17 SF100M", card,
        library=True)
    topk_vs_plain(table, names[0], names, card, "CB Q17")
    del table

    user = col(hb, "UserID")
    code = col(hb, "SearchPhrase")
    n_dic = len(hb.column_by_name("SearchPhrase").dictionary)
    out, counts, _ = run_path(ctx, CB_Q16, ["hash_group_aggregate",
                                            "group_topk", "compact_groups"],
                              card, "CB Q16", HITS_ROWS)
    add(counts)
    launched_as_predicted("CB Q16", counts, {"group_topk": TOPK_LAUNCHES})
    fold = "datafusion_tpu/device/groupby.py"
    source = kernels.KERNELS["hash_group_aggregate"].source
    variants.append(dict(name="hash_group_aggregate[CB Q16]", route="cuda",
                         source=source, replaces=f"{fold}:159",
                         launches=counts["hash_group_aggregate"], **k16))
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
    launched_as_predicted("CB Q17", counts, {"group_topk": TOPK_LAUNCHES,
                                             "compact_groups": 2})
    variants.append(dict(name="hash_group_aggregate[CB Q17]", route="cuda",
                         source=source, replaces=f"{fold}:393",
                         launches=counts["hash_group_aggregate"], **k17))
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

    # == count(DISTINCT x) and 180 lanes: ClickBench Q10 and Q30 ==============
    phase("count(DISTINCT x) and 180 lanes: ClickBench Q10 and Q30")
    variants += clickbench_q10_q30(ctx, hb, card, add)
    torch.cuda.empty_cache()

    # == sort: ClickBench Q25, Q26 and Q27 ====================================
    phase("sort: ClickBench Q25, Q26 and Q27")
    from datafusion_tpu_torch.physical.plan.device_sort import (
        sort_launch_count)
    from datafusion_tpu_torch.physical.plan.sort import SortExec
    event = col(hb, "EventTime")
    rows = np.flatnonzero(code != hb.column_by_name(
        "SearchPhrase").dictionary.lookup(""))
    phrases = hb.column_by_name("SearchPhrase").dictionary.values
    oracle_keys = {25: [event[rows]], 26: [code[rows]],
                   27: [event[rows], code[rows]]}
    host_ms, sort_calls = {}, {}
    for q in (25, 26, 27):
        ex, batch, secs, words = sort_input(ctx, CB_SORTS[q])
        host_ms[q] = secs * 1e3
        sort_calls[q] = sort_launch_count(words)
        print(f"CB Q{q} plans {ex.display_line()} over {batch.num_rows} "
              f"rows; its input (host filter and projection) took "
              f"{host_ms[q]:.3f} ms on its own", flush=True)
        kr, perm, _n = radix_vs_plain(words, dev, card, f"CB Q{q}",
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
                                  f"CB Q{q}", HITS_ROWS, SortExec,
                                  reps=SORT_REPS)
        add(counts)
        launched_as_predicted(f"CB Q{q}", counts,
                              {"radix_sort": sort_calls[q]},
                              runs=SORT_REPS + 1)
        want = phrases[code[rows[oracle_first(oracle_keys[q])]]].tolist()
        if out.columns[0].to_pylist() != want:
            raise AssertionError(f"CB Q{q} disagrees with numpy: "
                                 f"{out.columns[0].to_pylist()} {want}")
        print(f"CB Q{q} equals numpy exactly: {want[:3]}... of "
              f"{len(rows)} rows with a search phrase", flush=True)
        breakdown(ctx, CB_SORTS[q], card, f"CB Q{q}", SortExec,
                  main="onesweep_kernel",
                  host=f"filter and projection {host_ms[q]:.3f} ms run alone")
    del ctx, hb, user, code, event, rows, oracle_keys
    torch.cuda.empty_cache()

    # == entry points: the CLI, the bench runner, TPC-H, proto, the pod =====
    phase("entry points: the CLI, the bench runner, TPC-H SF 0.1 on the card "
          "against the CPU, proto and Substrait, the pod")
    entry_points_phase(dev, card)

    loaded = [m for m, v in sys.modules.items()
              if m.split(".")[0] in ("jax", "datafusion_tpu", "bench")
              and v is not None]
    if loaded:
        raise AssertionError(f"imported: {loaded}")
    print(f"smoke run: {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [dict(
        name=k.name, route="cuda", source=k.source, replaces=k.replaces,
        launches=launched[k.name], **report[k.name])
        for k in kernels.KERNELS.values()] + variants}))
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


# ---- walks across checkouts ------------------------------------------------

WALK_QUERIES = (3, 5, 7, 8, 9, 10, 12, 14, 18, 21)
ROWS_QUERIES = (2, 20)
WALK_REPS = 20
E2E_WALKS = (2, 5, 7, 8, 9, 12, 14, 20, 21)
K1_REPS = 10
WALK_SYMBOLS = (r"chain_(dense|hash|compose|fold)_kernel|"
                r"rows_(mark|walk|emit)_kernel|partition_\w+_kernel")


def warm_median(ctx, sql, reps=REPS):
    """The query end to end on the host's clock: a warm-up, then the
    median ms of `reps` runs."""
    ctx.sql(sql).collect_batch()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ctx.sql(sql).collect_batch()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def walk_resources(lib_path):
    """{kernel symbol: (registers, stack bytes)} of the walk kernels
    (`chain_dense_kernel`, `chain_hash_kernel`, the row walk's
    `rows_walk_kernel` or, in an older tree, `rows_mark_kernel`, and
    `rows_emit_kernel`), of `chain_compose_kernel`, `chain_fold_kernel`
    and of K1's kernels in the library at `lib_path`, from `cuobjdump
    --dump-resource-usage`."""
    return kernel_resources(lib_path, WALK_SYMBOLS)


def kernel_resources(lib_path, pattern):
    """{kernel symbol: (registers, stack bytes)} of the kernels whose
    symbol matches `pattern` in the library at `lib_path`, from `cuobjdump
    --dump-resource-usage` (spilled registers live on the stack)."""
    import re
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    out = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"),
                          "--dump-resource-usage", lib_path],
                         capture_output=True, text=True, check=True).stdout
    res, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        reg = re.search(r"REG:(\d+)", line)
        local = re.search(r"STACK:(\d+)", line)
        if reg and local and name and re.search(pattern, name):
            res[name] = (int(reg.group(1)), int(local.group(1)))
    return res


def cut_spec(spec, hop, flip=False):
    """A copy of the walk `spec` whose hop `hop` finds nothing: an empty
    INNER hop, so that the walk runs its probe predicate and the hops
    before `hop` and drops every row there (the time of that much of the
    walk); with `flip`, hop `hop` keeps its table and becomes ANTI (an
    INNER hop that every row matches then drops every row after its
    lookup: the walk without its fold)."""
    import copy
    from datafusion_tpu_torch.device import join_chain as J
    from datafusion_tpu_torch.device.groupby import H_OFF_CHAIN
    out = copy.copy(spec)
    metas = []
    for meta in spec.metas:
        meta = meta.copy()
        at = int(meta[H_OFF_CHAIN]) + J.C_HOPS + hop * J.HOP_WORDS
        if flip:
            meta[at + J.HOP_JTYPE] = J.JT_ANTI
        else:
            meta[at + J.HOP_KIND] = J.TAB_EMPTY
            meta[at + J.HOP_JTYPE] = J.JT_INNER
        metas.append(meta)
    out.metas = metas
    out.meta = metas[0]
    return out


def walk_split(spec, cols, aux, n, walk):
    """What the card spends on each part of one walk: the probe predicate
    alone (`cut_spec` at hop 0), the walk cut at each later hop, the walk
    without its fold (the last hop flipped to ANTI, where it is an INNER
    hop), the rows reaching and surviving each hop (the plain walk on the
    card), the launches a call, the live groups and the bound
    (`walk_bytes`, the live groups written once)."""
    import numpy as np
    import torch
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.groupby import (
        AggregateSpec, compact_groups_plain, dense_group_table)
    from datafusion_tpu_torch.device.join_chain import (
        JT_INNER, _walk_plain, chain_aggregate)
    dev = aux.device
    out = {}
    hop_rows = []
    _walk_plain(spec, cols, aux, n, hop_rows)
    out["hop_rows"] = hop_rows
    table = spec.new_table(dev)
    pristine = table.clone()
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    cuts = []
    for h in range(len(spec.chain.hops)):
        cut = cut_spec(spec, h)
        cuts.append(cuda_ms(lambda: chain_aggregate(cut, cols, aux, n, table,
                                                    overflow), WALK_REPS,
                            setup=lambda: table.copy_(pristine)))
    out["cut_ms"] = cuts
    last = len(spec.chain.hops) - 1
    out["nofold_ms"] = None
    if spec.chain.hops[last].jtype == JT_INNER and hop_rows[last][1] > 0:
        flip = cut_spec(spec, last, flip=True)
        out["nofold_ms"] = cuda_ms(
            lambda: chain_aggregate(flip, cols, aux, n, table, overflow),
            WALK_REPS, setup=lambda: table.copy_(pristine))
    table.copy_(pristine)
    before = kernels.launch_counts()["chain_aggregate"]
    walk()
    out["launches"] = kernels.launch_counts()["chain_aggregate"] - before
    table.copy_(pristine)
    chain_aggregate(spec, cols, aux, n, table, overflow,
                    spec.distinct_set(n, dev))
    t = dense_group_table(table) if isinstance(spec, AggregateSpec) \
        else table
    live = compact_groups_plain(t)
    out["groups"] = int(live.shape[1])
    nbytes = walk_bytes(spec, cols, n, hop_rows) + live.numel() * 8
    out["bound"] = bound(nbytes, 0)
    out["n"] = int(n)
    del table, pristine, t, live
    return out


def time_walks(ctx, queries, compose=None, splits=None):
    """{query: the mean device ms of its `chain_aggregate` walk over
    WALK_REPS calls}, staged as the imported tree stages it (with
    `compose` given, `prepare(ctx, compose)`); None where the tree plans
    no chain of the query on the card. With `splits` (a dict), each
    walk's `walk_split` goes into it too."""
    import torch
    from datafusion_tpu_torch.device.join_chain import chain_aggregate
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        DeviceLoweringUnsupported)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH
    tctx = ctx.task_context()
    walks = {}
    for q in queries:
        ex = find_exec(ctx.sql(TPCH[q]).create_physical_plan(),
                       TorchJoinChainAggregateExec)
        try:
            if ex is None:
                raise DeviceLoweringUnsupported("no chain exec")
            args = () if compose is None else (compose,)
            spec, _p, _n, _s, inputs, _staged = ex.prepare(tctx, *args)
        except Exception as e:   # an older tree plans less on the card
            walks[q] = None
            print(f"Q{q}: not on the card: {type(e).__name__}: {e}",
                  flush=True)
            continue
        ((cols, aux, n),) = inputs
        table = spec.new_table(aux.device)
        pristine = table.clone()
        overflow = torch.zeros(1, dtype=torch.int32, device=aux.device)

        def walk():
            chain_aggregate(spec, cols, aux, n, table, overflow)
        walks[q] = cuda_ms(walk, WALK_REPS,
                           setup=lambda: table.copy_(pristine))
        if splits is not None:
            splits[q] = walk_split(spec, cols, aux, n, walk)
            splits[q]["full_ms"] = walks[q]
        del spec, inputs, _staged, cols, aux, table, pristine
        torch.cuda.empty_cache()
    return walks


def record_partitions(mod):
    """Replace `partition_rows` in the module `mod` by a recorder that
    keeps each call's inputs (the pending flags as they were) and then
    makes the call; returns (the list of recorded calls, a function that
    puts the original back)."""
    orig = mod.partition_rows
    calls = []

    def recorder(keys, pending, n_dest, cap, lanes=(), salt=1,
                 salt_mode=1, salt_r=0):
        calls.append((keys, pending.clone(), n_dest, cap, list(lanes), salt,
                      salt_mode, salt_r))
        return orig(keys, pending, n_dest, cap, lanes, salt, salt_mode,
                    salt_r)
    mod.partition_rows = recorder
    return calls, lambda: setattr(mod, "partition_rows", orig)


def k1_calls(ctx, label, sql):
    """K1 (`partition_rows`) on every call one run of the mesh query `sql`
    makes: each call's rows, destinations, cap and lanes, its mean device
    ms over K1_REPS calls (the pending flags restored before each) and its
    launches; the largest call split by kernel (torch.profiler) beside a
    stable `torch.argsort` of its owners."""
    import torch
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.exchange import (partition_rows,
                                                      shard_owner)
    from datafusion_tpu_torch.parallel import exchange as X
    ctx.sql(sql).collect_batch()
    calls, restore = record_partitions(X)
    try:
        ctx.sql(sql).collect_batch()
    finally:
        restore()
    if not calls:
        raise AssertionError(f"{label} made no K1 call")
    out = []
    for keys, pend0, n_dest, cap, lanes, salt, mode, salt_r in calls:
        pend = pend0.clone()

        def call():
            partition_rows(keys, pend, n_dest, cap, lanes, salt, mode,
                           salt_r)
        ms = cuda_ms(call, K1_REPS, setup=lambda: pend.copy_(pend0))
        pend.copy_(pend0)
        before = kernels.launch_counts()["partition_rows"]
        call()
        out.append({"rows": int(keys.numel()),
                    "pending": int(pend0.sum()), "n_dest": n_dest,
                    "cap": int(cap), "lanes": len(lanes), "salt": salt,
                    "ms": ms, "launches":
                    kernels.launch_counts()["partition_rows"] - before})
    big = max(range(len(calls)), key=lambda i: out[i]["pending"])
    keys, pend0, n_dest, cap, lanes, salt, mode, salt_r = calls[big]
    pend = pend0.clone()

    def call():
        pend.copy_(pend0)
        partition_rows(keys, pend, n_dest, cap, lanes, salt, mode, salt_r)
    split = kernel_ms(call)
    owner = shard_owner(keys, n_dest)
    argsort = cuda_ms(lambda: torch.argsort(owner, stable=True), K1_REPS)
    print(f"{label}: {len(calls)} K1 calls, "
          f"{sum(c['ms'] for c in out):.6f} ms in all", flush=True)
    return {"calls": out, "total_ms": sum(c["ms"] for c in out),
            "largest": big, "largest_split": split,
            "largest_argsort_ms": argsort}


def walk_tree(tree):
    """The walks of WALK_QUERIES and ROWS_QUERIES, K1 on MJ1's and MQ15's
    calls and Q5, Q12, Q14, Q21, MJ1 and MQ15 end to end, with `tree`'s
    package; prints one JSON line."""
    import inspect
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import datafusion_tpu_torch as dft
    if not dft.__file__.startswith(tree + os.sep):
        raise AssertionError(f"imported {dft.__file__}, not from {tree}")
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.join_chain import chain_rows
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec, TorchJoinChainRowsExec)
    from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH
    kernels.library()
    tables = tpch_tables(10, seed=0)
    dev = torch.device(DEVICE)
    ctx = dft.SessionContext(dev)
    for tname, b in tables.items():
        ctx.register_table(tname, dft.MemTable(b.schema, [[b]]))
    tctx = ctx.task_context()
    # a tree whose staging composes also times each walk staged without
    # (`prepare(ctx, compose=False)`), in the same process
    splits, splits_unstaged = {}, {}
    if "compose" in inspect.signature(
            TorchJoinChainAggregateExec.prepare).parameters:
        walks = time_walks(ctx, WALK_QUERIES, True, splits)
        unstaged = time_walks(ctx, WALK_QUERIES, False, splits_unstaged)
    else:
        walks, unstaged = time_walks(ctx, WALK_QUERIES, None, splits), {}
    # a tree that stages a chain in one call (`stage_spec`) also times each
    # walk staged with its compositions and without its folds
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchChainExec)
    composed_only = {}
    if hasattr(TorchChainExec, "stage_spec"):
        plan = TorchChainExec.compose_plan
        TorchChainExec.compose_plan = lambda self, staged: (
            plan(self, staged)[0], {})
        try:
            composed_only = time_walks(ctx, WALK_QUERIES, True)
        finally:
            TorchChainExec.compose_plan = plan
    rows, rows_launches, rows_split = {}, {}, {}
    for q in ROWS_QUERIES:
        ex = find_exec(ctx.sql(TPCH[q]).create_physical_plan(),
                       TorchJoinChainRowsExec)
        if ex is None:
            rows[q] = None
            continue
        spec, inputs, _staged = ex.prepare_rows(tctx)
        ((cols, aux, n, _view),) = inputs
        rows[q] = cuda_ms(lambda: chain_rows(spec, cols, aux, n), WALK_REPS)
        before = kernels.launch_counts()["chain_rows"]
        chain_rows(spec, cols, aux, n)
        rows_launches[q] = kernels.launch_counts()["chain_rows"] - before
        rows_split[q] = kernel_ms(lambda: chain_rows(spec, cols, aux, n))
        del spec, inputs, _staged, cols, aux
        torch.cuda.empty_cache()
    # each chain's staging as the tree stages it (compositions and folds)
    staging = {}
    for q in WALK_QUERIES + ROWS_QUERIES:
        cls = TorchJoinChainRowsExec if q in ROWS_QUERIES else \
            TorchJoinChainAggregateExec
        ex = find_exec(ctx.sql(TPCH[q]).create_physical_plan(), cls)
        staging[q] = None if ex is None else staging_cost(ex, tctx)
        del ex
    e2e = {f"Q{q}": warm_median(ctx, TPCH[q]) for q in E2E_WALKS}
    del ctx, tctx
    torch.cuda.empty_cache()
    mesh = dft.SessionContext(dev)
    mesh.config.set("datafusion.tpu.mesh_devices", MESH_SHARDS)
    for tname, b in tables.items():
        mesh.register_table(tname, dft.MemTable(b.schema, [[b]]))
    k1 = {"MJ1": k1_calls(mesh, "MJ1 SF10", MJ1),
          "MQ15": k1_calls(mesh, "MQ15 SF10", Q15_SUB)}
    e2e["MJ1"] = warm_median(mesh, MJ1)
    e2e["MQ15"] = warm_median(mesh, Q15_SUB)
    print(json.dumps({"tree": tree, "walk_ms": walks,
                      "walk_ms_uncomposed": unstaged,
                      "walk_ms_composed_only": composed_only,
                      "rows_ms": rows,
                      "rows_launches": rows_launches,
                      "rows_split": rows_split,
                      "staging": staging,
                      "walk_split": splits,
                      "walk_split_uncomposed": splits_unstaged,
                      "k1": k1, "e2e_ms": e2e,
                      "resources": {kernel_label(k): v for k, v in
                                    walk_resources(str(kernels.LIB)).items()}}),
          flush=True)


MARK_REPS = 20
MARK_SYMBOLS = r"compact_(mark|copy)_kernel|merge_partials_kernel"


def mark_tree(tree):
    """Kernel rows 11 and 21 with `tree`'s package, through its own entry
    points: on Q18's subquery at SF10 (its group table folded once),
    `compact_groups` with its HAVING and without (CUDA events, mean of
    MARK_REPS; the mark and copy passes' device ms, profiled, mean of 10;
    launches a call; the HAVING's conjunct forms where the tree has them)
    and as a run of the query makes it, its HAVING lowered anew (the
    parent uploads the descriptor each call), and the query end to end;
    K2 on every call of one run of MQ1, MQ15, MJ1 and MB on 4 shards of
    the card (each recorded from the tree's own path and replayed on fresh
    tables, the L2 flushed: ms a call and their sum by CUDA events and
    profiled device ms; K2's profiled device ms in a warm run of the whole
    query, mean of 3; launches a run, the host ms of one merge step's
    local tables as the tree makes them) and each query end to end (warm
    median of REPS); and the
    kernels' registers and stack bytes. Prints one JSON line."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import datafusion_tpu_torch as dft
    if not dft.__file__.startswith(tree + os.sep):
        raise AssertionError(f"imported {dft.__file__}, not from {tree}")
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.groupby import compact_groups
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    from datafusion_tpu_torch.physical.plan.distributed_aggregate import (
        TorchDistributedJoinAggregateExec)
    kernels.library()
    dev = torch.device(DEVICE)
    tables = tpch_tables(10, seed=0)
    ctx = dft.SessionContext(dev)
    for tname, b in tables.items():
        ctx.register_table(tname, dft.MemTable(b.schema, [[b]]))
    ex = find_exec(ctx.sql(Q18_SUB).create_physical_plan(),
                   TorchGroupAggregateExec)
    batches = ex.input_batches(ctx.task_context())
    spec, plan, names, slot_map = ex.compile(batches)
    table = ex.group_table(spec, batches, True)
    hv = ex.having(spec, plan, names, slot_map)
    out = {"tree": tree, "forms": getattr(hv, "forms", None),
           "slots": int(table.shape[1]),
           "groups": int((table[0] != -1).sum())}
    for label, h in (("with HAVING", hv), ("no HAVING", None)):
        before = kernels.launch_counts()["compact_groups"]
        kept = int(compact_groups(table, h).shape[1])
        launches = kernels.launch_counts()["compact_groups"] - before
        out[f"Q18 sub {label}"] = dict(
            kept=kept, launches=launches,
            ms=cuda_ms(lambda: compact_groups(table, h), MARK_REPS),
            device_ms=kernel_ms(lambda: compact_groups(table, h), 10))
    # as a run of the query makes the call: its HAVING lowered anew
    out["Q18 sub with HAVING"]["main_ms"] = cuda_ms(
        lambda: compact_groups(table, ex.having(spec, plan, names, slot_map)),
        MARK_REPS)
    del table, batches, ex
    torch.cuda.empty_cache()
    e2e = {"Q18 sub": warm_median(ctx, Q18_SUB)}
    del ctx
    q1ctx, mesh = dft.SessionContext(dev), dft.SessionContext(dev)
    for c in (q1ctx, mesh):
        c.config.set("datafusion.tpu.mesh_devices", MESH_SHARDS)
    sf10 = make_lineitem(SF10_ROWS, seed=0)
    q1ctx.register_table("lineitem", dft.MemTable(sf10.schema, [[sf10]]))
    for tname, b in tables.items():
        mesh.register_table(tname, dft.MemTable(b.schema, [[b]]))
    mb = MB
    jex = find_exec(mesh.sql(mb).create_physical_plan(),
                    TorchDistributedJoinAggregateExec)
    if "s_suppkey" not in [f.name for f in jex.build_source.schema()]:
        mb = mb.replace("FROM lineitem JOIN supplier",
                        "FROM supplier JOIN lineitem")
    del jex
    merges = {}
    for label, c, sql in (("MQ1", q1ctx, Q1), ("MQ15", mesh, Q15_SUB),
                          ("MJ1", mesh, MJ1), ("MB", mesh, mb)):
        calls, launches = merge_calls(c, sql, label)
        query = kernel_ms(lambda: c.sql(sql).collect_batch(), 3)
        per, device = [], []
        for call in calls:
            run, setup, _held = replay(call)
            per.append(cuda_ms(run, MARK_REPS, setup))

            def fresh_run():
                setup()
                run()
            device.append(sum(v for k, v in kernel_ms(fresh_run, 10).items()
                              if "merge_partials" in k))
        into = calls[0][1][1]

        def tables_step():
            if hasattr(into, "tables"):      # one object, all local tables
                type(into)(into.kinds, into.limit, MESH_SHARDS, dev)
            else:                            # a table a shard
                for _ in range(MESH_SHARDS):
                    type(into)(into.kinds, into.limit, dev)
            torch.cuda.synchronize()
        tables_step()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            tables_step()
            times.append((time.perf_counter() - t0) * 1e3)
        merges[label] = dict(
            calls=len(calls), launches=launches, ms=sum(per), call_ms=per,
            device_ms=sum(device), call_device_ms=device,
            query_device_ms=sum(v for k, v in query.items()
                                if "merge_partials" in k),
            entries=[[e.shape[1] for e in (call[1][0] if isinstance(
                call[1][0], (list, tuple)) else [call[1][0]])]
                for call in calls],
            tables_host_ms=statistics.median(times))
        e2e[label] = warm_median(c, sql)
        del calls
    out["merge"] = merges
    out["e2e_ms"] = e2e
    out["resources"] = {kernel_label(k): v for k, v in kernel_resources(
        str(kernels.LIB), MARK_SYMBOLS).items()}
    print(json.dumps(out), flush=True)


def ab_main(flag, trees, inputs=None) -> int:
    """An A/B run on one card: each tree's `flag` child (`--walk-tree`,
    `--sort-tree`, `--fold-tree`, `--hash-tree`, `--scan-tree`,
    `--mark-tree`) in a process of its own, in the order
    given, between two lines of the card's name and power limit. With
    `inputs`, the inputs are made once first, with this checkout's
    package, in a directory that each child gets as its second argument
    and that is removed at the end."""
    import shutil
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    card = smi()
    print(card, flush=True)
    extra = []
    if inputs is not None:
        for blocked in ("jax", "datafusion_tpu", "bench"):
            sys.modules[blocked] = None
        root = os.path.dirname(os.path.abspath(__file__))
        sys.path.insert(0, root)
        extra = [os.path.join(root, "_chip", "ab_inputs")]
        t0 = time.perf_counter()
        inputs(extra[0])
        print(f"inputs made in {time.perf_counter() - t0:.1f} s", flush=True)
    try:
        for tree in trees:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                flag, tree, *extra], capture_output=True,
                               text=True)
            print(r.stdout.strip(), flush=True)
            if r.returncode:
                print(r.stderr[-4000:], file=sys.stderr)
                return r.returncode
    finally:
        for d in extra:
            shutil.rmtree(d, ignore_errors=True)
    print(card)
    return 0


# ---- the sort and top-k kernels across checkouts -----------------------------

SORT_SHAPES = ("CB Q25", "CB Q26", "CB Q27", "W1")
SORT_SYMBOLS = (r"\d(onesweep_kernel|word_hist_kernel|gather_kernel|"
                r"scatter_kernel|block_hist_kernel|pack_kernel|"
                r"gather_records_kernel|direct_kernel|gather_lanes_kernel)|"
                r"topk_\w+_kernel|compact_\w+_kernel")


def kernel_label(sym):
    """A kernel's name from its mangled symbol, with its template
    arguments: `onesweep_kernel<u64>`, `compact_mark_kernel<1,0>`,
    `pack_kernel<32>`."""
    import re
    m = re.search(r"\d+([a-z_]+_kernel)(I((?:L[a-z]\d+E|[a-z])+)E)?", sym)
    if m.group(3) is None:
        return m.group(1)
    args = [a or {"y": "u64", "h": "u8"}.get(t, t) for a, t in
            re.findall(r"L[a-z](\d+)E|([a-z])", m.group(3))]
    return f"{m.group(1)}<{','.join(args)}>"


def sort_inputs(data):
    """The inputs of `--sorts`, made once with this checkout's package
    and saved under `data`: the order words of CB Q25-Q27 (the rows with a
    search phrase, as `sort_input` encodes them) and of W1's first window
    evaluation (as `stage_window` stages them), and the live slots, keys
    and order lanes of CB Q16's and Q17's group tables."""
    import numpy as np
    import torch
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.device.groupby import (
        EMPTY, hash_group_aggregate)
    from datafusion_tpu_torch.device.window import stage_window
    from datafusion_tpu_torch.physical.plan.base import collect_batch
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    from datafusion_tpu_torch.physical.plan.window import (
        WindowExec, _plan_window_evaluation, device_window_inputs)
    os.makedirs(data, exist_ok=True)
    dev = torch.device(DEVICE)
    hb = hits(HITS_ROWS, seed=0)
    ctx = dft.SessionContext(dev)
    ctx.register_table("hits", dft.MemTable(hb.schema, [[hb]]))
    for q in (16, 17):
        sql = (CB_Q16 if q == 16 else CB_Q17).split(" ORDER BY")[0]
        ex = find_exec(ctx.sql(sql).create_physical_plan(),
                       TorchGroupAggregateExec)
        (batch,) = ex.input_batches(ctx.task_context())
        spec, _plan, names, _slots = ex.compile([batch])
        cols, aux = ex.stage(spec, batch)
        table = spec.new_table(dev)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        hash_group_aggregate(spec, cols, aux, batch.num_rows, table,
                             overflow)
        live = (table[0] != EMPTY).nonzero().squeeze(1)
        np.savez(os.path.join(data, f"CB Q{q}.npz"), cap=table.shape[1],
                 slots=live.cpu().numpy(), keys=table[0][live].cpu().numpy(),
                 lane=table[2 + names.index(names[0])][live].cpu().numpy())
        del table, cols, aux, live
    for q in (25, 26, 27):
        _ex, _batch, _secs, words = sort_input(ctx, CB_SORTS[q])
        np.savez(os.path.join(data, f"CB Q{q}.npz"),
                 *[np.ascontiguousarray(w) for w in words])
    del ctx, hb
    li = tpch_tables(10, seed=0)["lineitem"]
    ctx = dft.SessionContext(dev)
    ctx.register_table("lineitem", dft.MemTable(li.schema, [[li]]))
    ex = find_exec(ctx.sql(W1).create_physical_plan(), WindowExec)
    batch = collect_batch(ex.input, ctx.task_context())
    w = _plan_window_evaluation(ex.window_exprs,
                                ex.input.output_ordering())[0]
    spec, pw, ow, lanes, _arg = device_window_inputs(w, batch)
    words, _lanes = stage_window(pw, ow, batch.num_rows, spec, **lanes,
                                 device=dev)
    np.savez(os.path.join(data, "W1.npz"), *[
        t.cpu().numpy().view(np.uint64 if t.dtype == torch.int64
                             else np.uint8) for t in words])


def kernel_ms(fn, reps: int = 1) -> dict:
    """Device ms by kernel of a call of `fn` (after a warm-up), from
    torch.profiler: the mean over `reps` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CUDA:
            key = ev.key.replace("(anonymous namespace)::", "")
            key = key.split("(")[0][-40:]
            out[key] = round(out.get(key, 0.0) + getattr(
                ev, "self_device_time_total", 0) / 1e3 / reps, 4)
    return out


def sort_tree(tree, data):
    """`radix_sort` on the words of SORT_SHAPES, `reorder_rows` of W1's
    words through their permutation, and `group_topk` (k = 10,
    descending) and `compact_groups` on CB Q16's and Q17's tables with
    `tree`'s package, each through `radix_vs_plain`, `gather_vs_plain`,
    `topk_vs_plain` and `compaction_vs_plain` (against its plain version,
    launches recorded, not predicted: the parent counts its own); prints
    one JSON line of kernel, plain, library and bound ms, launches a call,
    and the kernels' registers and stack bytes, and each kernel's device ms
    in one profiled call."""
    import numpy as np
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import datafusion_tpu_torch as dft
    if not dft.__file__.startswith(tree + os.sep):
        raise AssertionError(f"imported {dft.__file__}, not from {tree}")
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.groupby import compact_groups, group_topk
    from datafusion_tpu_torch.physical.plan.device_sort import (
        radix_sort, to_word)
    kernels.library()
    dev = torch.device(DEVICE)
    card = smi()
    out = {"tree": tree}
    for label in SORT_SHAPES:
        with np.load(os.path.join(data, f"{label}.npz")) as z:
            host = [z[f"arr_{i}"] for i in range(len(z.files))]
        kr, perm, launches = radix_vs_plain(host, dev, card, label,
                                            library=True, predicted=False)
        words = [to_word(w).to(dev) for w in host]
        out[label] = dict(rows=len(host[0]), words=len(host),
                          launches=launches, **kr,
                          device_ms=kernel_ms(lambda: radix_sort(words)))
        if label == "W1":
            out["W1 gather"] = gather_vs_plain(
                torch.from_numpy(perm).to(dev), words, card, label)
        del words, perm
        torch.cuda.empty_cache()
    for label in ("CB Q16", "CB Q17"):
        with np.load(os.path.join(data, f"{label}.npz")) as z:
            cap, slots = int(z["cap"]), torch.from_numpy(z["slots"]).to(dev)
            table = torch.zeros((3, cap), dtype=torch.int64, device=dev)
            table[0] = -1
            table[0, slots] = torch.from_numpy(z["keys"]).to(dev)
            table[2, slots] = torch.from_numpy(z["lane"]).to(dev)
        kt, launches = topk_vs_plain(table, "lane", ["lane"], card, label,
                                     predicted=False)
        out[label] = dict(
            slots=cap, groups=int(slots.numel()), launches=launches, **kt,
            device_ms=kernel_ms(lambda: group_topk(table, 2, False, 10)))
        kc, launches = compaction_vs_plain(table, None, label, card,
                                           predicted=False)
        out[f"{label} compact"] = dict(
            slots=cap, groups=int(slots.numel()), launches=launches, **kc,
            device_ms=kernel_ms(lambda: compact_groups(table)))
        del table, slots
        torch.cuda.empty_cache()
    out["resources"] = {
        kernel_label(sym): rs for sym, rs in
        kernel_resources(str(kernels.LIB), SORT_SYMBOLS).items()}
    print(json.dumps(out), flush=True)


# ---- the dense fold and the join probe across checkouts ----------------------

FOLD_WALKS = (5, 12, 14)
FOLD_SYMBOLS = (r"fused_dense_aggregate_kernel|chain_dense_kernel|"
                r"join_aggregate_kernel|join_build_\w+_kernel")
FOLD_REPS = {"Q1 SF10": 20, "Q6 SF10": 20, "CB Q30": 3}
JOIN_REPS = 5


def fold_tree(tree):
    """Row 1's dense fold on Q1, Q6 (SF10) and CB Q30, the dense walks of
    FOLD_WALKS (`time_walks`, as `--walks` times them) and `join_build` +
    `join_aggregate` on J1 and J2, with `tree`'s package; prints one JSON
    line: the mean device ms of each (CUDA events), the folds and joins
    end to end (`warm_median`), the launches a call, and the registers and
    stack bytes of the kernels (`cuobjdump`)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import datafusion_tpu_torch as dft
    if not dft.__file__.startswith(tree + os.sep):
        raise AssertionError(f"imported {dft.__file__}, not from {tree}")
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.groupby import dense_group_aggregate
    from datafusion_tpu_torch.device.join_agg import (join_aggregate,
                                                      join_build)
    from datafusion_tpu_torch.physical.plan.base import (collect_batch,
                                                         execute_stream)
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    from datafusion_tpu_torch.physical.plan.device_join_agg import (
        TorchJoinAggregateExec)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        _PairView)
    kernels.library()
    dev = torch.device(DEVICE)
    out = {"tree": tree, "fold_ms": {}, "walk_ms": {}, "join_ms": {},
           "e2e_ms": {}, "launches": {}}

    def launches(name, fn):
        before = dft.launch_counts()[name]
        fn()
        return dft.launch_counts()[name] - before

    def dense(ctx, label, sql):
        ex = find_exec(ctx.sql(sql).create_physical_plan(),
                       TorchGroupAggregateExec)
        (batch,) = ex.input_batches(ctx.task_context())
        spec, _plan, _names, _slots = ex.compile([batch])
        cols, aux = ex.stage(spec, batch)
        table = spec.new_table(dev)

        def fold():
            dense_group_aggregate(spec, cols, aux, batch.num_rows, table)
        out["fold_ms"][label] = cuda_ms(fold, FOLD_REPS[label])
        out["launches"][label] = launches("fused_dense_aggregate", fold)
        del spec, cols, aux, table
        out["e2e_ms"][label] = warm_median(ctx, sql)

    li = make_lineitem(SF10_ROWS, seed=0)
    ctx = dft.SessionContext(dev)
    ctx.register_table("lineitem", dft.MemTable(li.schema, [[li]]))
    dense(ctx, "Q1 SF10", Q1)
    dense(ctx, "Q6 SF10", Q6)
    del ctx, li
    hb = hits(HITS_ROWS, seed=0)
    ctx = dft.SessionContext(dev)
    ctx.register_table("hits", dft.MemTable(hb.schema, [[hb]]))
    dense(ctx, "CB Q30", CB_Q30)
    del ctx, hb
    torch.cuda.empty_cache()
    tables = tpch_tables(10, seed=0)
    ctx = dft.SessionContext(dev)
    for tname, b in tables.items():
        ctx.register_table(tname, dft.MemTable(b.schema, [[b]]))
    tctx = ctx.task_context()
    out["walk_ms"] = {f"Q{q}": ms for q, ms in
                      time_walks(ctx, FOLD_WALKS).items()}
    for label, sql in (("J1 SF10", J1), ("J2 SF10", J2)):
        ex = find_exec(ctx.sql(sql).create_physical_plan(),
                       TorchJoinAggregateExec)
        lowered = ex.lower()
        bb = collect_batch(ex.build_source, tctx)
        bspec, bcols, baux = ex.build_input(lowered, bb)
        built = [join_build(bspec, bcols, baux, bb.num_rows)]
        (pb,) = [b for b in execute_stream(ex.probe_source, tctx)
                 if b.num_rows]
        view = _PairView(list(bb.columns) + list(pb.columns), pb.num_rows)
        spec, _plan, _names, _sm = ex.compile_join(lowered, built[0], [view])
        cols, aux = ex.stage_pair(spec, bb, pb, view)
        table = spec.new_table(dev)
        pristine = table.clone()
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)

        def build():
            built[0] = join_build(bspec, bcols, baux, bb.num_rows)

        def probe():
            join_aggregate(spec, cols, aux, pb.num_rows, table, overflow)
        # the last timed table is freed before each build, so that the
        # caching allocator reuses its memory instead of asking for more
        b_ms = cuda_ms(build, JOIN_REPS,
                       setup=lambda: built.__setitem__(0, None))
        p_ms = cuda_ms(probe, JOIN_REPS, setup=lambda: table.copy_(pristine))
        out["join_ms"][label] = {"join_build": b_ms, "join_aggregate": p_ms,
                                 "sum": b_ms + p_ms,
                                 "table_bytes": spec.join.table.nbytes}
        built[0] = None
        out["launches"][label] = {"join_build": launches("join_build", build),
                                  "join_aggregate": launches(
                                      "join_aggregate", probe)}
        del spec, cols, aux, table, pristine, built, bcols
        torch.cuda.empty_cache()
        out["e2e_ms"][label] = warm_median(ctx, sql)
    out["resources"] = {kernel_label(k): v for k, v in
                        kernel_resources(str(kernels.LIB),
                                         FOLD_SYMBOLS).items()}
    print(json.dumps(out), flush=True)


# ---- the hash group fold across checkouts -----------------------------------

HASH_SYMBOLS = r"hash_group_aggregate_kernel"
HASH_REPS = 10


def hash_tree(tree):
    """Rows 5, 6, 7 and 9's hash fold with `tree`'s package: the mean
    device ms (CUDA events, each call from a pristine table and an empty
    distinct set) of `hash_group_aggregate` on CB Q16, CB Q16 over a
    uniform `UserID` (the same 16,666,249 users), CB Q17, CB Q10 (its
    distinct lane), Q18's and Q15's subqueries (SF10); `torch.unique(...,
    return_counts=True)` on CB Q16's and Q17's packed keys
    (`unique_yardstick`); CB Q16 and Q17 end to end (`warm_median`); the
    launches a call; and the registers and stack bytes of both variants
    of the kernel (`cuobjdump`). Prints one JSON line."""
    import numpy as np
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import datafusion_tpu_torch as dft
    if not dft.__file__.startswith(tree + os.sep):
        raise AssertionError(f"imported {dft.__file__}, not from {tree}")
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.common import dt
    from datafusion_tpu_torch.common.column import Column
    from datafusion_tpu_torch.device.groupby import (compact_groups,
                                                     hash_group_aggregate)
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    kernels.library()
    dev = torch.device(DEVICE)
    out = {"tree": tree, "fold_ms": {}, "unique_ms": {}, "e2e_ms": {},
           "launches": {}, "groups": {}}

    def fold(ctx, label, sql, distinct=False, unique=False):
        ex = find_exec(ctx.sql(sql).create_physical_plan(),
                       TorchGroupAggregateExec)
        (batch,) = ex.input_batches(ctx.task_context())
        spec, _plan, _names, _slots = ex.compile([batch])
        cols, aux = ex.stage(spec, batch)
        n = batch.num_rows
        table = spec.new_table(dev)
        pristine = table.clone()
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        dset = spec.distinct_set(n, dev) if distinct else None

        def reset():
            table.copy_(pristine)
            if dset is not None:
                dset.words.zero_()

        def call():
            hash_group_aggregate(spec, cols, aux, n, table, overflow, dset)
        out["fold_ms"][label] = cuda_ms(call, HASH_REPS, setup=reset)
        reset()
        before = dft.launch_counts()["hash_group_aggregate"]
        call()
        out["launches"][label] = \
            dft.launch_counts()["hash_group_aggregate"] - before
        torch.cuda.synchronize()
        if int(overflow.item()):
            raise AssertionError(f"{label}: the fold overflowed")
        groups = int(compact_groups(table).shape[1])
        out["groups"][label] = groups
        del table, pristine, dset
        if unique:
            out["unique_ms"][label] = unique_yardstick(spec, cols, aux, n,
                                                       groups, label)
        del spec, cols, aux
        torch.cuda.empty_cache()

    hb = hits(HITS_ROWS, seed=0)
    rng = np.random.default_rng(1)
    users = rng.integers(0, max(HITS_ROWS // 6, 10), HITS_ROWS)
    ub = make_batch([("UserID", Column(dt.INT64, users))])
    del users
    ctx = dft.SessionContext(dev)
    ctx.register_table("hits", dft.MemTable(hb.schema, [[hb]]))
    ctx.register_table("hits_uniform", dft.MemTable(ub.schema, [[ub]]))
    fold(ctx, "CB Q16", CB_Q16.split(" ORDER BY")[0], unique=True)
    fold(ctx, "CB Q16 uniform", CB_Q16.split(" ORDER BY")[0].replace(
        "FROM hits", "FROM hits_uniform"))
    fold(ctx, "CB Q17", CB_Q17.split(" ORDER BY")[0], unique=True)
    fold(ctx, "CB Q10", CB_Q10.split(" ORDER BY")[0], distinct=True)
    for label, sql in (("CB Q16", CB_Q16), ("CB Q17", CB_Q17)):
        out["e2e_ms"][label] = warm_median(ctx, sql)
    del ctx, hb, ub
    torch.cuda.empty_cache()
    tables = tpch_tables(10, seed=0)
    ctx = dft.SessionContext(dev)
    for tname, b in tables.items():
        ctx.register_table(tname, dft.MemTable(b.schema, [[b]]))
    fold(ctx, "Q18 sub SF10", Q18_SUB)
    fold(ctx, "Q15 sub SF10", Q15_SUB)
    out["resources"] = {kernel_label(k): v for k, v in
                        kernel_resources(str(kernels.LIB),
                                         HASH_SYMBOLS).items()}
    print(json.dumps(out), flush=True)


# ---- the window scan and the chain build across checkouts ----------------------

SCAN_SYMBOLS = (r"flags_kernel|scan_(reduce|top|apply)_kernel|eval_kernel|"
                r"window_pass_kernel|chain_build_\w+_kernel")
SCAN_REPS = 5
SCAN_BUILDS = (4, 21, 3, 5)
SCAN_E2E = (4, 21)


def scan_tree(tree):
    """Row 20's window scan and rows 14-15's chain build with `tree`'s
    package: on every window evaluation of W1, W2 and W3 (each partition
    run of W3) over the SF10 lineitem, sorted and gathered by the tree's
    kernels, `window_scan` against its plain version, its mean device ms
    (CUDA events) beside the floor every design pays, `index_copy_` of one
    int64 lane through the permutation; on every build side of TPC-H Q4,
    Q21, Q3 and Q5 at SF10, `check_build`, the mean device ms of
    `chain_build` and its `build_yardstick`; for each, the launches a call
    and the device ms of each kernel in one profiled call (`kernel_ms`);
    Q4, Q21 (warm median of REPS) and W1 (one run after a warm-up) end to
    end; the registers and stack bytes of the kernels (`cuobjdump`).
    Prints one JSON line."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import datafusion_tpu_torch as dft
    if not dft.__file__.startswith(tree + os.sep):
        raise AssertionError(f"imported {dft.__file__}, not from {tree}")
    from datafusion_tpu_torch import kernels
    from datafusion_tpu_torch.device.groupby import reorder_rows
    from datafusion_tpu_torch.device.join_chain import chain_build
    from datafusion_tpu_torch.device.window import (
        stage_window, window_scan, window_scan_plain)
    from datafusion_tpu_torch.physical.plan.device_join_chain import (
        TorchJoinChainAggregateExec)
    from datafusion_tpu_torch.physical.plan.device_sort import radix_sort
    from datafusion_tpu_torch.physical.plan.window import (
        _plan_window_evaluation, device_window_inputs)
    from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH
    kernels.library()
    dev = torch.device(DEVICE)
    out = {"tree": tree, "scan": {}, "build": {}, "e2e_ms": {}}

    def launches(name, fn):
        before = dft.launch_counts()[name]
        fn()
        return dft.launch_counts()[name] - before

    tables = tpch_tables(10, seed=0)
    ctx = dft.SessionContext(dev)
    for tname, b in tables.items():
        ctx.register_table(tname, dft.MemTable(b.schema, [[b]]))
    tctx = ctx.task_context()
    for q in SCAN_BUILDS:
        ex = find_exec(ctx.sql(TPCH[q]).create_physical_plan(),
                       TorchJoinChainAggregateExec)
        for h, bi in enumerate(ex.build_inputs(tctx)):
            n = bi.batch.num_rows
            label = f"Q{q} build {h}"
            got = check_build(bi, label)

            def call():
                chain_build(bi.spec, bi.cols, bi.aux, n, bi.unique)
            out["build"][label] = dict(
                rows=n, live=got.live, slots=got.size,
                kind=["direct", "hashed", "empty"][got.kind],
                mmx=got.mn is not None, unique=bi.unique,
                ms=cuda_ms(call, SCAN_REPS), launches=launches(
                    "chain_build", call),
                library=build_yardstick(bi, got, SCAN_REPS),
                device_ms=kernel_ms(call))
            del got
            torch.cuda.empty_cache()
    for q in SCAN_E2E:
        out["e2e_ms"][f"Q{q}"] = warm_median(ctx, TPCH[q])
    li = tables["lineitem"]
    del ctx, tables, tctx
    torch.cuda.empty_cache()
    ctx = dft.SessionContext(dev)
    ctx.register_table("lineitem", dft.MemTable(li.schema, [[li]]))
    for qname, sql in (("W1", W1), ("W2", W2), ("W3", W3)):
        ex, runs, _n = window_batches(ctx, sql, all_runs=True)
        for r, batch in enumerate(runs):
            n = batch.num_rows
            for w in _plan_window_evaluation(ex.window_exprs,
                                             ex.input.output_ordering()):
                spec, pw, ow, lanes, _arg = device_window_inputs(w, batch)
                words, lanes = stage_window(pw, ow, n, spec, **lanes,
                                            device=dev)
                perm = radix_sort(words)
                extras = [x for x in lanes if x is not None]
                moved = reorder_rows(perm, words + extras)
                sw, rest = moved[:len(words)], iter(moved[len(words):])
                sl = [None if x is None else next(rest) for x in lanes]
                del moved, rest, extras, words, lanes
                label = f"{qname}{f' run {r}' if len(runs) > 1 else ''} " \
                    f"{spec}"
                got = window_scan(sw, len(pw), perm, spec, *sl)
                want = window_scan_plain(sw, len(pw), perm, spec, *sl)
                if any(not torch.equal(got[k], want[k]) for k in want):
                    raise AssertionError(f"{label}: window_scan differs")
                del got, want

                def call():
                    window_scan(sw, len(pw), perm, spec, *sl)
                x = torch.zeros(n, dtype=torch.int64, device=dev)
                y = torch.empty_like(x)
                out["scan"][label] = dict(
                    rows=n, ms=cuda_ms(call, SCAN_REPS),
                    floor_index_copy_ms=cuda_ms(
                        lambda: y.index_copy_(0, perm, x), SCAN_REPS),
                    launches=launches("window_scan", call),
                    device_ms=kernel_ms(call))
                del sw, sl, perm, x, y
                torch.cuda.empty_cache()
    ctx.sql(W1).collect_batch()
    t0 = time.perf_counter()
    ctx.sql(W1).collect_batch()
    out["e2e_ms"]["W1"] = (time.perf_counter() - t0) * 1e3
    out["resources"] = {kernel_label(k): v for k, v in
                        kernel_resources(str(kernels.LIB),
                                         SCAN_SYMBOLS).items()}
    print(json.dumps(out), flush=True)


def host_joins_main() -> int:
    """J1 and J2 at SF10 through the port's host plan (`datafusion.tpu.
    device_aggregate` off: a numpy HashJoinExec under an AggregateExec),
    one run each after planning, each against numpy: the time a user had
    before the join-aggregate ran on the card."""
    for blocked in ("jax", "datafusion_tpu", "bench"):
        sys.modules[blocked] = None
    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.physical.plan.joins import HashJoinExec
    print(f"host: {os.cpu_count()} cores; card {smi()}", flush=True)
    tables = tpch_tables(10, seed=0)
    ctx = dft.SessionContext(torch.device("cpu"))
    ctx.sql("SET datafusion.tpu.device_aggregate = false")
    for tname, b in tables.items():
        ctx.register_table(tname, dft.MemTable(b.schema, [[b]]))
    for label, sql, oracle in (("J1 SF10", J1, oracle_j1),
                               ("J2 SF10", J2, oracle_j2)):
        if find_exec(ctx.sql(sql).create_physical_plan(),
                     HashJoinExec) is None:
            raise AssertionError(f"{label} plans no host HashJoinExec")
        t0 = time.perf_counter()
        out = ctx.sql(sql).collect_batch()
        secs = time.perf_counter() - t0
        got = [c.data_host() for c in out.columns]
        if not all(np.array_equal(a, b) for a, b in zip(got, oracle(tables))):
            raise AssertionError(f"{label} on the host disagrees with numpy")
        print(f"{label} on the port's host plan: {secs * 1e3:.3f} ms, "
              f"equals numpy", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--host-joins"]:
        sys.exit(host_joins_main())
    if sys.argv[1:2] == ["--walks"]:
        sys.exit(ab_main("--walk-tree", sys.argv[2:]))
    if sys.argv[1:2] == ["--walk-tree"]:
        sys.exit(walk_tree(sys.argv[2]))
    if sys.argv[1:2] == ["--sorts"]:
        sys.exit(ab_main("--sort-tree", sys.argv[2:], sort_inputs))
    if sys.argv[1:2] == ["--sort-tree"]:
        sys.exit(sort_tree(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--hash"]:
        sys.exit(ab_main("--hash-tree", sys.argv[2:]))
    if sys.argv[1:2] == ["--hash-tree"]:
        sys.exit(hash_tree(sys.argv[2]))
    if sys.argv[1:2] == ["--scans"]:
        sys.exit(ab_main("--scan-tree", sys.argv[2:]))
    if sys.argv[1:2] == ["--scan-tree"]:
        sys.exit(scan_tree(sys.argv[2]))
    if sys.argv[1:2] == ["--marks"]:
        sys.exit(ab_main("--mark-tree", sys.argv[2:]))
    if sys.argv[1:2] == ["--mark-tree"]:
        sys.exit(mark_tree(sys.argv[2]))
    if sys.argv[1:2] == ["--folds"]:
        sys.exit(ab_main("--fold-tree", sys.argv[2:]))
    if sys.argv[1:2] == ["--fold-tree"]:
        sys.exit(fold_tree(sys.argv[2]))
    sys.exit(main())
