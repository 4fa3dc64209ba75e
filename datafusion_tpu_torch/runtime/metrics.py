"""Per-operator execution metrics.

Reference parity: `datafusion/physical-plan/src/metrics/` —
ExecutionPlanMetricsSet (`mod.rs:351`), BaselineMetrics (`baseline.rs:47`),
typed values (`value.rs:38-347`). Surfaced by EXPLAIN ANALYZE.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple


# per-chip speed-of-light: TPU v5e HBM bandwidth (819 GB/s, public spec)
SOL_HBM_GBPS = 819.0


class Count:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, n: int):
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v: int):
        self.value = v

    def add(self, n: int):
        self.value += n


class Time:
    """Accumulated nanoseconds, used as a context manager."""

    __slots__ = ("nanos", "_t0")

    def __init__(self):
        self.nanos = 0
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.nanos += time.perf_counter_ns() - self._t0
        return False

    def __str__(self):
        if self.nanos >= 1e9:
            return f"{self.nanos/1e9:.3f}s"
        if self.nanos >= 1e6:
            return f"{self.nanos/1e6:.3f}ms"
        return f"{self.nanos/1e3:.1f}µs"


class MetricsSet:
    """All metrics of one operator, labeled (name, partition)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Optional[int]], object] = {}

    def counter(self, name: str, partition: Optional[int] = None) -> Count:
        return self._get(name, partition, Count)

    def gauge(self, name: str, partition: Optional[int] = None) -> Gauge:
        return self._get(name, partition, Gauge)

    def timer(self, name: str, partition: Optional[int] = None) -> Time:
        return self._get(name, partition, Time)

    def _get(self, name, partition, cls):
        key = (name, partition)
        if key not in self._metrics:
            self._metrics[key] = cls()
        return self._metrics[key]

    def sum(self, name: str) -> int:
        """Aggregate a metric across partitions."""
        total = 0
        for (n, _), m in self._metrics.items():
            if n == name:
                total += getattr(m, "value", getattr(m, "nanos", 0))
        return total

    def items(self) -> List[Tuple[str, Optional[int], object]]:
        return [(n, p, m) for (n, p), m in self._metrics.items()]

    def summary(self) -> str:
        agg: Dict[str, int] = {}
        times: Dict[str, int] = {}
        for (n, _), m in self._metrics.items():
            if isinstance(m, Time):
                times[n] = times.get(n, 0) + m.nanos
            else:
                agg[n] = agg.get(n, 0) + m.value
        parts = [f"{k}={v}" for k, v in agg.items()
                 if not (v == 0 and k == "bytes_touched")]
        for k, v in times.items():
            if v == 0 and k == "device_compute":
                continue
            parts.append(f"{k}={v/1e6:.3f}ms")
        # speed-of-light accounting (BASELINE.md north star: operators at
        # >=80% of per-chip SOL): achieved HBM bandwidth of the device
        # section vs the chip's peak
        nbytes = agg.get("bytes_touched", 0)
        dev_ns = times.get("device_compute", 0)
        if nbytes and dev_ns:
            gbps = nbytes / dev_ns        # bytes/ns == GB/s
            parts.append(
                f"achieved={gbps:.1f}GB/s ({100 * gbps / SOL_HBM_GBPS:.0f}% "
                f"of v5e HBM {SOL_HBM_GBPS:.0f}GB/s SOL)")
        return ", ".join(parts)


class BaselineMetrics:
    """output_rows + elapsed_compute for every operator
    (reference: metrics/baseline.rs:47)."""

    def __init__(self, metrics: MetricsSet, partition: int):
        self.output_rows = metrics.counter("output_rows", partition)
        self.elapsed_compute = metrics.timer("elapsed_compute", partition)
        # SOL accounting for device operators (filled by device execs)
        self.bytes_touched = metrics.counter("bytes_touched", partition)
        self.device_compute = metrics.timer("device_compute", partition)

    def record_output(self, rows: int):
        self.output_rows.add(rows)

    def record_bytes(self, n: int):
        self.bytes_touched.add(int(n))
