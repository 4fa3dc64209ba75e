"""One run of one cell: make the tables from the seed, hand them to the
program, warm every query template, drive the cell's query stream for the
window, then check every answer against the plain reference.

`run` does all but look for the card, so that the tests can drive it on
the CPU; `run.py` is the command."""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import itertools
import json
import math
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path

import torch

from portbench import check, program, roofline
from portbench.datagen import Streams
from portbench.spans import union
from portbench.trace import Tracer, breakdown, kernel_names

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "datafusion_tpu"}
# the share of a traced run's queries that may sit in chunks left out for
# lost kernel events before the run fails. A chunk holds whole rounds of
# the cell's templates, so leaving one out biases no template.
MAX_DROPPED_SHARE = 0.05


def quantity(metric: str) -> str:
    """What a metric measures: its name up to the first dot. A quantity
    split among cells (`queries_per_s` and `queries_per_s.chains`, each
    with a bound of its own) is taken alike in each, and a per-layer
    quantity is read by `metrics/<quantity>.py`."""
    return metric.split(".", 1)[0]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of `BENCHMARK.json` with the files it names: its workload,
    its configuration and generator, its SQL, its references and its
    metrics' readers, each found by name under `<root>/portbench`."""

    def __init__(self, name: str, root: Path = ROOT):
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        entry = entries[name]
        pb = root / "portbench"
        self.name, self.chips = name, entry["chips"]
        self.workload = json.loads((pb / "workloads" / f"{name}.json")
                                   .read_text())
        if not self.workload.get("queries") or \
                self.workload["trace_chunk"] % len(self.workload["queries"]):
            raise ValueError(f"{name}: a workload names at least one query, "
                             "and its traced chunk holds whole rounds")
        cfg = entry["config"]
        if self.workload["config"] != cfg:
            raise ValueError(f"{name}: the workload file's configuration "
                             f"is not BENCHMARK.json's {cfg!r}")
        self.config = json.loads((pb / "configs" / f"{cfg}.json").read_text())
        self.generator = load_module(pb / "configs" / f"{cfg}.py",
                                     f"portbench_config_{cfg}")
        self.sql = {q: (pb / "queries" / cfg / f"{q}.sql").read_text()
                    for q in self.workload["queries"]}
        self.references = {
            q: load_module(pb / "reference" / cfg / f"{q}.py",
                           f"portbench_reference_{cfg}_{q}").reference
            for q in self.workload["queries"]}

        def mine(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.readers = {m["name"]: load_module(
            pb / "metrics" / f"{quantity(m['name'])}.py",
            f"portbench_metric_{quantity(m['name'])}").read
            for m in manifest["per_layer"] if mine(m)}
        self.units = {m["name"]: m["unit"] for m in
                      manifest["end_to_end"] + manifest["per_layer"]}

    def columns(self) -> set:
        """The configuration's columns that the cell's SQL names."""
        return set().union(*(roofline.named_columns(s, self.generator.COLUMNS)
                             for s in self.sql.values()))

    def tables(self, seed: int, device, scale: float = 1.0) -> dict:
        """The cell's columns made on `device` from `seed`."""
        return self.generator.tables(self.config, Streams(seed, device),
                                     self.columns(), scale)


def to_device(tables: dict, device) -> dict:
    """The tables with every column's data moved to `device` (a host
    column's numpy data as a tensor there)."""
    def move(data):
        t = data if isinstance(data, torch.Tensor) else torch.from_numpy(data)
        return t.to(device)
    return {t: {c: dataclasses.replace(col, data=move(col.data))
                for c, col in cols.items()} for t, cols in tables.items()}


def to_host(tables: dict) -> dict:
    return {t: {c: dataclasses.replace(col, data=col.data.cpu().numpy())
                for c, col in cols.items()} for t, cols in tables.items()}


def references(cell: Cell, tables: dict, device, lower: bool = False):
    """{query: rows} of the plain reference over the tables on `device`."""
    from portbench.reference.common import Arith
    on_device = to_device(tables, device)
    ar = Arith(lower)
    return {q: fn(on_device, ar) for q, fn in cell.references.items()}


def percentile(values, p: float) -> float:
    """The nearest-rank p-th percentile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(p / 100.0 * len(ordered)) - 1, 0)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drive(ctx, cell: Cell, seconds: float, device, tracer=None) -> dict:
    """The traffic: a closed loop of one client that sends the workload's
    query templates in the file's order, round after round, each when the
    last answer is on the host and with no pause, for `seconds`. Each
    query's record: (query, answer or None where it failed, latency s,
    front-end s)."""
    marked = (lambda name: torch.profiler.record_function(name)) \
        if tracer else (lambda name: nullcontext())
    queries = itertools.cycle(cell.workload["queries"])
    records = []
    start = time.perf_counter()
    end = start + seconds
    while time.perf_counter() < end:
        q = next(queries)
        t0 = time.perf_counter()
        t1, batch = None, None
        try:
            with marked("pb.query"):
                with marked("pb.sql"):
                    df = ctx.sql(cell.sql[q])
                t1 = time.perf_counter()
                with marked("pb.collect"):
                    batch = df.collect_batch()
                    sync(device)
        except Exception:  # noqa: BLE001 - a failed query is counted
            print(f"{q} failed:\n{traceback.format_exc(limit=-4)}",
                  file=sys.stderr)
        t2 = time.perf_counter()
        records.append((q, batch, t2 - t0, None if t1 is None else t1 - t0))
        if tracer:
            tracer.step()
    return {"records": records, "window_s": time.perf_counter() - start}


def latencies(records) -> str:
    """Each template's answered count, median and 95th percentile ms."""
    by_q = {}
    for q, batch, lat, _f in records:
        if batch is not None:
            by_q.setdefault(q, []).append(lat * 1000.0)
    return ", ".join(f"{q} {len(v)} x {percentile(v, 50):.3f} / "
                     f"{percentile(v, 95):.3f} ms" for q, v in by_q.items())


def warm(ctx, cell: Cell, device) -> None:
    """Each query template once: the plan cache, the chain caches and the
    columns' residency, as the window will find them."""
    for q in cell.workload["queries"]:
        ctx.sql(cell.sql[q]).collect_batch()
    sync(device)


def dropped_queries(traced: dict, answers) -> dict:
    """{template: queries} of the traced chunks left out for lost kernel
    events. Raises where they hold more than MAX_DROPPED_SHARE of the
    traced queries, or where no chunk is kept."""
    out = {}
    for _i, _launched, _seen, steps in traced["dropped"]:
        for step in steps:
            out[answers[step][0]] = out.get(answers[step][0], 0) + 1
    left_out = sum(out.values())
    if not traced["chunks"] or \
            left_out > MAX_DROPPED_SHARE * (left_out + len(traced["steps"])):
        raise RuntimeError(
            f"the profiler lost kernel events in chunks holding {left_out} "
            f"of {left_out + len(traced['steps'])} traced queries (chunk, "
            f"launched, seen): {[d[:3] for d in traced['dropped']]}; at "
            f"most {MAX_DROPPED_SHARE:.0%} may be left out")
    return out


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        scale: float = 1.0, root: Path = ROOT, t0: float = None,
        log=print) -> dict:
    """One run of the cell `name`; returns the result line's object."""
    t0 = time.time() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    cell = Cell(name, root)
    split = {}

    def lap(key, since):
        split[key] = time.time() - since
        return time.time()

    t = lap("start", t0)          # the interpreter, torch, the card's look
    made = cell.tables(seed, device, scale)
    sync(device)
    t = lap("generate", t)
    tables = to_host(made)
    del made
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = lap("to_host", t)
    ctx = program.session(device)
    t = lap("program", t)
    program.register(ctx, tables)
    t = lap("register", t)
    warm(ctx, cell, device)
    lap("warm", t)
    setup_s = time.time() - t0
    log("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
        + f"; setup_s {setup_s:.3f}")

    tracer = None
    if trace:
        tracer = Tracer(cell.workload.get("trace_chunk", 20),
                        kernel_names(program.csrc()) if cuda else [],
                        program.launches)
    with tracer or nullcontext():
        window = drive(ctx, cell, seconds, device, tracer)
    sync(device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    records = window.pop("records")
    log("latency (answers x median / p95): " + latencies(records))
    answers = [(q, None if b is None else check.rows_of(b))
               for q, b, _l, _f in records]
    timing = [(q, lat, front) for q, b, lat, front in records
              if b is not None]
    fronts = [front for _q, _b, _l, front in records]
    del ctx, records
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.time()
    want = references(cell, tables, device)
    numbers = check.judge(answers, want, cell.workload["limits"])
    log(f"check: {len(answers)} answers against the reference in "
        f"{time.time() - t:.3f} s")
    failed = len(answers) - len(timing)
    result = {"correct": bool(check.passed(numbers) and failed == 0
                              and timing),
              "attempted": len(answers), "failed": failed}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": peak}
    if not trace:
        lat = [x for _q, x, _f in timing]
        values = {"queries_per_s": len(lat) / window["window_s"],
                  "latency_p95_ms": 1000.0 * percentile(lat, 95)
                  if lat else None,
                  "setup_s": setup_s}
        metrics = {m["name"]: values[quantity(m["name"])]
                   for m in cell.end_to_end}
    else:
        traced = tracer.result()
        log(f"trace: {len(traced['chunks'])} chunks of {traced['queries']} "
            f"queries kept; left out, the profiler having lost kernel "
            f"events (chunk, launched, seen): "
            f"{[d[:3] for d in traced['dropped']]}")
        result["dropped_queries"] = dropped_queries(traced, answers)
        traced["frontend_s"] = [fronts[i] for i in traced["steps"]
                                if fronts[i] is not None]
        arrays = {t_: {c: col.data for c, col in cols.items()}
                  for t_, cols in tables.items()}
        needs = {q: roofline.input_bytes(s, arrays) +
                 roofline.result_bytes(want[q]) for q, s in cell.sql.items()}
        traced["bytes_needed"] = sum(needs[answers[i][0]]
                                     for i in traced["steps"])
        traced["peak_bytes_per_s"] = roofline.peak_bytes_per_s(
            device_info["kind"])
        metrics = {k: read(traced) for k, read in cell.readers.items()}
        device_info["busy_s"] = union((a, b) for _n, _k, a, b
                                      in traced["device"])
        device_info["window_s"] = traced["window_s"]
        result["breakdown"] = breakdown(traced)
    result["metrics"] = {k: {"value": v, "unit": cell.units[k]}
                         for k, v in metrics.items() if v is not None}
    result["device"] = device_info
    result["check"] = numbers
    return result


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the port's runs must not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & FORBIDDEN)


def report(result: dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output."""
    for k, n in result["check"].items():
        print(f"check {k} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
