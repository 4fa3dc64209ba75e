"""The traced run: the window profiled in chunks of queries by a
`torch.profiler` schedule, each chunk's events kept in memory as plain
tuples, and each chunk's kernel events checked against the program's
launch counters.

A chunk's window runs from its first query's start to its last query's
end (the benchmark's `pb.query` spans); device intervals and host spans
are clipped to it. The time between chunks, in which the profiler hands
over its events, is in no chunk."""
from __future__ import annotations

import re
import warnings
from pathlib import Path

from portbench.spans import merged

SPAN_PREFIXES = ("dft.", "pb.")


def kernel_names(csrc: Path) -> list:
    """The `__global__` functions of the program's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        text = re.sub(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)", "",
                      path.read_text())
        names.update(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return sorted(names)


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


class Tracer:
    """Profiles steps (one query each) in cycles of one warm-up step, which
    starts the profiler and is not kept, and `chunk` recorded steps."""

    def __init__(self, chunk: int, kernels: list, launches):
        import torch
        self.torch = torch
        self.chunk = chunk
        self.pattern = re.compile(r"\b(" + "|".join(map(re.escape, kernels))
                                  + r")\b") if kernels else None
        self.launches = launches      # () -> total launches so far
        self.raw = []                 # a chunk's (spans, device events)
        self.totals = []              # launches before each step, and after
        self.prof = None

    def __enter__(self):
        tp = self.torch.profiler
        acts = [tp.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        warnings.filterwarnings("ignore", "Profiler won't be using warmup")
        warnings.filterwarnings("ignore", ".*Profiler clears events")
        self.prof = tp.profile(
            activities=acts,
            schedule=tp.schedule(wait=0, warmup=1, active=self.chunk),
            on_trace_ready=self._ready)
        self.totals.append(self.launches())
        self.prof.__enter__()
        return self

    def step(self):
        self.totals.append(self.launches())
        self.prof.step()

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def launched(self, i: int) -> int:
        """Launches counted in the recorded steps of the i-th cycle."""
        first = i * (self.chunk + 1) + 1
        last = min(first + self.chunk, len(self.totals) - 1)
        return self.totals[last] - self.totals[first]

    def _ready(self, prof):
        spans, device = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start, end = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            if name.startswith(SPAN_PREFIXES):
                if e.device_type() == self.torch.autograd.DeviceType.CPU:
                    spans.append((name, start, end))
            elif e.device_type() == self.torch.autograd.DeviceType.CUDA:
                kind = ("memcpy" if name.startswith("Memcpy") else
                        "memset" if name.startswith("Memset") else "kernel")
                device.append((name, kind, start, end))
        self.raw.append((spans, device))

    def result(self) -> dict:
        """The trace that the metric readers read: host spans, device
        intervals, chunks and the kernel check, over the chunks that hold
        a query and every kernel event that the program counted: a chunk in
        which the profiler kept fewer of the program's kernel events than
        the program launched is left out (`dropped`: the chunk, launches,
        events kept and its steps), so no idle share is read from a trace
        with holes."""
        trace = {"spans": [], "device": [], "chunks": [], "queries": 0,
                 "steps": [], "dropped": [], "window_s": 0.0}
        for i, (spans, device) in enumerate(self.raw):
            queries = [(a, b) for n, a, b in spans if n == "pb.query"]
            if not queries:
                continue
            lo, hi = min(a for a, _ in queries), max(b for _, b in queries)
            inside = [(n, k, max(a, lo), min(b, hi)) for n, k, a, b in device
                      if b > lo and a < hi]
            first = i * (self.chunk + 1) + 1
            steps = range(first, min(first + self.chunk, len(self.totals) - 1))
            if self.pattern is not None:
                launched = self.launched(i)
                seen = sum(1 for n, k, _a, _b in inside
                           if k == "kernel" and self.pattern.search(n))
                if seen < launched:
                    trace["dropped"].append((i, launched, seen, list(steps)))
                    continue
            trace["chunks"].append((lo, hi))
            trace["steps"] += steps
            trace["window_s"] += hi - lo
            trace["queries"] += len(queries)
            trace["spans"] += [(n, max(a, lo), min(b, hi))
                               for n, a, b in spans if b > lo and a < hi]
            trace["device"] += inside
        return trace


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, by kernel name, and the
    device's idle time by what the host was doing: the innermost host span
    around the middle of each idle gap, or `harness` outside any."""
    by_op = {}
    for name, _kind, a, b in trace["device"]:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + (b - a)
    gaps = {}
    for lo, hi in trace["chunks"]:
        busy = merged([(a, b) for _n, _k, a, b in trace["device"]
                       if a < hi and b > lo])
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        spans = [(n, a, b) for n, a, b in trace["spans"]
                 if a < hi and b > lo and n != "pb.query"]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            around = [(sb - sa, n) for n, sa, sb in spans if sa <= mid <= sb]
            key = min(around)[1] if around else "harness"
            gaps[key] = gaps.get(key, 0.0) + (b - a)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(gaps)}
