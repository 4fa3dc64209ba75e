"""Execution runtime: per-query resources, memory accounting, metrics.

Reference parity: `datafusion/execution` (RuntimeEnv, TaskContext,
MemoryPool — SURVEY.md §2.1) and `datafusion/physical-plan/src/metrics`.
"""
from .disk import DiskManager  # noqa: F401
from .memory import (  # noqa: F401
    FairSpillPool, GreedyMemoryPool, MemoryPool, MemoryReservation,
    UnboundedMemoryPool,
)
from .metrics import (  # noqa: F401
    BaselineMetrics, Count, Gauge, MetricsSet, Time,
)
from .runtime_env import RuntimeEnv, TaskContext  # noqa: F401
