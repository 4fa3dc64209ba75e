"""Interactive SQL REPL.

Reference parity: `datafusion-cli` (`datafusion-cli/src/exec.rs:64-206`,
`print_format.rs`, memory-pool flags `main.rs:94-99`).

    python -m datafusion_tpu_torch [-f script.sql] [-c "SELECT ..."] \
        [--format table|csv|json] [--memory-limit BYTES] [--device cuda|cpu]

The session takes the card (`--device cuda`, the default) unless it is
given the CPU, where each kernel runs its plain PyTorch version; with no
card, asking for it raises.
"""
from __future__ import annotations

import argparse
import sys
import time


def _print_batches(df, fmt: str) -> None:
    if fmt == "table":
        print(df.format(limit=200))
        return
    batch = df.collect_batch()
    names = batch.schema.names()
    cols = [c.to_pylist(batch.num_rows) for c in batch.columns]
    if fmt == "csv":
        import csv as _csv
        w = _csv.writer(sys.stdout)
        w.writerow(names)
        for row in zip(*cols):
            w.writerow(row)
    elif fmt == "json":
        import json
        for row in zip(*cols):
            print(json.dumps(dict(zip(names, row)), default=str))


def _exec_and_print(ctx, sql: str, fmt: str, timing: bool) -> None:
    t0 = time.perf_counter()
    df = ctx.sql(sql)
    _print_batches(df, fmt)
    if timing:
        print(f"Elapsed {time.perf_counter() - t0:.3f} seconds.")


def repl(ctx, fmt: str = "table") -> None:
    try:
        import readline  # noqa: F401 — line editing / history
    except ImportError:
        pass
    print("datafusion-tpu SQL shell.  \\q to quit, \\d to list tables, "
          "\\d <table> to describe.")
    buf = []
    while True:
        try:
            prompt = "df> " if not buf else "  > "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return
        s = line.strip()
        if not buf and s.startswith("\\"):
            if s in ("\\q", "\\quit"):
                return
            if s == "\\d":
                _exec_and_print(ctx, "SHOW TABLES", fmt, False)
                continue
            if s.startswith("\\d "):
                _exec_and_print(ctx, f"DESCRIBE {s[3:]}", fmt, False)
                continue
            print(f"unknown command {s}")
            continue
        buf.append(line)
        if s.endswith(";") or (s and not buf[:-1] and ";" in s):
            sql = "\n".join(buf).rstrip().rstrip(";")
            buf = []
            if not sql.strip():
                continue
            try:
                _exec_and_print(ctx, sql, fmt, True)
            except Exception as e:  # noqa: BLE001 — REPL survives query errors
                print(f"{type(e).__name__}: {e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="datafusion-tpu")
    p.add_argument("-c", "--command", action="append", default=[],
                   help="execute this SQL and exit")
    p.add_argument("-f", "--file", action="append", default=[],
                   help="execute the SQL in this file and exit")
    p.add_argument("--format", default="table",
                   choices=["table", "csv", "json"])
    p.add_argument("--memory-limit", type=int, default=0,
                   help="greedy memory pool size in bytes (0 = unbounded)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the session's device; cpu runs each kernel's plain "
                   "PyTorch version (default: cuda)")
    args = p.parse_args(argv)

    from . import SessionContext
    from .runtime import GreedyMemoryPool, RuntimeEnv
    runtime = None
    if args.memory_limit:
        runtime = RuntimeEnv(memory_pool=GreedyMemoryPool(args.memory_limit))
    ctx = SessionContext(args.device, runtime=runtime)
    # the reference CLI enables information_schema at startup
    # (datafusion-cli/src/main.rs with_information_schema(true))
    ctx.sql("SET datafusion.catalog.information_schema = true")

    scripts = []
    for f in args.file:
        with open(f) as fh:
            scripts.append(fh.read())
    scripts.extend(args.command)
    if scripts:
        for script in scripts:
            for stmt in _split_statements(script):
                _exec_and_print(ctx, stmt, args.format, False)
        return 0
    repl(ctx, args.format)
    return 0


def _split_statements(text: str):
    # naive split on ';' outside quotes
    out, cur, q = [], [], None
    for ch in text:
        if q:
            cur.append(ch)
            if ch == q:
                q = None
            continue
        if ch in ("'", '"'):
            q = ch
            cur.append(ch)
        elif ch == ";":
            stmt = "".join(cur).strip()
            if stmt:
                out.append(stmt)
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
