"""Benchmark runner (the reference's `dfbench` analog).

    python -m datafusion_tpu_torch.bench_runner tpch --sf 0.1 [--iterations 3]
    python -m datafusion_tpu_torch.bench_runner clickbench --rows 1000000
    python -m datafusion_tpu_torch.bench_runner h2o --rows 1000000

Prints per-query timings and a JSON summary line. Every suite's session
takes the card (`--device cuda`, the default) unless it is given the CPU
(`--device cpu`), where each kernel runs its plain PyTorch version; with no
card, asking for it raises.
"""
from __future__ import annotations

import argparse
import json
import time


def run_tpch(sf: float, iterations: int, device_aggregate: bool,
             device: str) -> dict:
    from . import SessionContext
    from .tpch import QUERIES, register_tpch
    ctx = SessionContext(device)
    if not device_aggregate:
        ctx.config.set("datafusion.tpu.device_aggregate", False)
    t0 = time.time()
    register_tpch(ctx, sf=sf)
    load = time.time() - t0
    print(f"load {load:.1f}s")
    results = {}
    for n in sorted(QUERIES):
        best = None
        for _ in range(iterations):
            t0 = time.time()
            ctx.sql(QUERIES[n]).collect_batch()
            dt_ = time.time() - t0
            best = dt_ if best is None else min(best, dt_)
        results[f"q{n}"] = round(best * 1000, 1)
        print(f"Q{n:02d}  {best*1000:8.1f} ms")
    return results


def run_clickbench(rows: int, iterations: int, device: str) -> dict:
    from . import SessionContext
    from .clickbench import QUERIES, register_hits
    ctx = SessionContext(device)
    register_hits(ctx, n=rows)
    results = {}
    for n in sorted(QUERIES):
        best = None
        for _ in range(iterations):
            t0 = time.time()
            ctx.sql(QUERIES[n]).collect_batch()
            dt_ = time.time() - t0
            best = dt_ if best is None else min(best, dt_)
        results[f"cb{n}"] = round(best * 1000, 1)
        print(f"CB{n:02d}  {best*1000:8.1f} ms")
    return results


H2O_QUERIES = [
    # the h2o.ai db-benchmark groupby set (reference: benchmarks/src/bin/h2o.rs)
    "SELECT id1, sum(v1) AS v1 FROM x GROUP BY id1",
    "SELECT id1, id2, sum(v1) AS v1 FROM x GROUP BY id1, id2",
    "SELECT id3, sum(v1) AS v1, avg(v3) AS v3 FROM x GROUP BY id3",
    "SELECT id4, avg(v1) AS v1, avg(v2) AS v2, avg(v3) AS v3 FROM x GROUP BY id4",
    "SELECT id6, sum(v1) AS v1, sum(v2) AS v2, sum(v3) AS v3 FROM x GROUP BY id6",
    "SELECT id4, id5, median(v3) AS median_v3, stddev(v3) AS sd_v3 FROM x "
    "GROUP BY id4, id5",
    "SELECT id3, max(v1) - min(v2) AS range_v1_v2 FROM x GROUP BY id3",
    "SELECT id2, id4, power(corr(v1, v2), 2) AS r2 FROM x GROUP BY id2, id4",
    "SELECT id1, id2, id3, id4, id5, id6, sum(v3) AS v3, count(*) AS cnt "
    "FROM x GROUP BY id1, id2, id3, id4, id5, id6",
]


def run_h2o(rows: int, iterations: int, device: str) -> dict:
    import numpy as np
    from . import SessionContext
    rng = np.random.default_rng(0)
    k = max(rows // 100, 10)
    data = {
        "id1": rng.choice([f"id{i:03d}" for i in range(k // 10 + 1)], rows
                          ).astype(object),
        "id2": rng.choice([f"id{i:03d}" for i in range(k // 10 + 1)], rows
                          ).astype(object),
        "id3": rng.choice([f"id{i:010d}" for i in range(k)], rows).astype(object),
        "id4": rng.integers(1, k // 10 + 2, rows),
        "id5": rng.integers(1, k // 10 + 2, rows),
        "id6": rng.integers(1, k + 1, rows),
        "v1": rng.integers(1, 6, rows),
        "v2": rng.integers(1, 16, rows),
        "v3": np.round(rng.uniform(0, 100, rows), 6),
    }
    ctx = SessionContext(device)
    ctx.register_arrays("x", data)
    results = {}
    for i, q in enumerate(H2O_QUERIES, 1):
        best = None
        for _ in range(iterations):
            t0 = time.time()
            ctx.sql(q).collect_batch()
            dt_ = time.time() - t0
            best = dt_ if best is None else min(best, dt_)
        results[f"h2o_q{i}"] = round(best * 1000, 1)
        print(f"h2o Q{i}  {best*1000:8.1f} ms")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="datafusion-tpu-bench")
    p.add_argument("suite", choices=["tpch", "clickbench", "h2o"])
    p.add_argument("--sf", type=float, default=0.1)
    p.add_argument("--rows", type=int, default=1_000_000)
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--no-device", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the session's device; cpu runs each kernel's plain "
                        "PyTorch version (default: cuda)")
    args = p.parse_args(argv)
    if args.suite == "tpch":
        results = run_tpch(args.sf, args.iterations, not args.no_device,
                           args.device)
    elif args.suite == "clickbench":
        results = run_clickbench(args.rows, args.iterations, args.device)
    else:
        results = run_h2o(args.rows, args.iterations, args.device)
    print(json.dumps({"suite": args.suite, "ms": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
