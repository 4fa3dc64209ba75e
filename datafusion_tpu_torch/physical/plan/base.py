"""ExecutionPlan base + plan-wide helpers.

Reference parity: the `ExecutionPlan` trait
(`datafusion/physical-plan/src/lib.rs:136-520`), `Partitioning`
(`physical-expr/src/partitioning.rs:108`), `collect`/`execute_stream`
(`lib.rs:714,730`).
"""
from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Sequence

from ...common.batch import Batch, concat_batches
from ...common.errors import internal
from ...common.schema import Schema
from ...runtime import MetricsSet, TaskContext


class PartitioningKind(enum.Enum):
    ROUND_ROBIN = "RoundRobinBatch"
    HASH = "Hash"
    UNKNOWN = "UnknownPartitioning"


class Partitioning:
    """Output partitioning of an operator
    (reference: partitioning.rs:108-116)."""

    def __init__(self, kind: PartitioningKind, n: int, exprs=None):
        self.kind = kind
        self.n = n
        self.exprs = exprs or []

    @staticmethod
    def unknown(n: int) -> "Partitioning":
        return Partitioning(PartitioningKind.UNKNOWN, n)

    @staticmethod
    def hash(exprs, n: int) -> "Partitioning":
        return Partitioning(PartitioningKind.HASH, n, exprs)

    @staticmethod
    def round_robin(n: int) -> "Partitioning":
        return Partitioning(PartitioningKind.ROUND_ROBIN, n)

    def __str__(self):
        if self.kind == PartitioningKind.HASH:
            return f"Hash([{', '.join(map(str, self.exprs))}], {self.n})"
        return f"{self.kind.value}({self.n})"


class ExecutionPlan:
    """Base class of all physical operators."""

    def __init__(self):
        self.metrics = MetricsSet()

    # ---- structure -------------------------------------------------------
    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> List["ExecutionPlan"]:
        return []

    def with_children(self, children: Sequence["ExecutionPlan"]) -> "ExecutionPlan":
        if children:
            raise internal(f"{type(self).__name__}.with_children not implemented")
        return self

    # ---- properties --------------------------------------------------------
    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(1)

    def maintains_input_order(self) -> bool:
        return False

    def unbounded(self) -> bool:
        """True when this operator can emit forever (reference:
        ExecutionMode::Unbounded, physical-plan/src/lib.rs:524). Default:
        unbounded iff any input is — a fetch/limit re-bounds the stream
        (overridden there)."""
        return any(c.unbounded() for c in self.children())

    def output_ordering(self):
        """Ordering of emitted rows as [(expr_str, asc, nulls_first)] or
        None (reference: PlanProperties.output_ordering /
        EquivalenceProperties orderings, equivalence/properties.rs —
        expressions compared by display string, the pragmatic
        equivalence-class check). Order-preserving operators inherit the
        child ordering."""
        if self.maintains_input_order() and self.children():
            return self.children()[0].output_ordering()
        return None

    def output_orderings(self):
        """ALL valid orderings of the output (EquivalenceProperties keeps a
        set; operators with one claim return a singleton)."""
        if self.maintains_input_order() and self.children():
            return self.children()[0].output_orderings()
        o = self.output_ordering()
        return [o] if o else []

    def equivalence_properties(self):
        """Full EquivalenceProperties of this output: equal-expression
        classes, constants, and orderings (reference:
        ExecutionPlan::equivalence_properties, physical-plan/src/lib.rs +
        equivalence/properties.rs). Order-preserving unary operators
        inherit the child's classes/constants wholesale; operators that
        create equalities (filters, joins, projections) override."""
        from ..equivalence import EquivalenceProperties
        if self.maintains_input_order() and len(self.children()) == 1:
            return self.children()[0].equivalence_properties()
        return EquivalenceProperties(orderings=self.output_orderings())

    def name(self) -> str:
        return type(self).__name__

    # ---- execution ---------------------------------------------------------
    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        raise NotImplementedError

    def reset_state(self) -> None:
        """Clear per-execution cached state (e.g. a CollectLeft build).

        RecursiveQueryExec re-executes the same physical subtree every
        iteration; the reference scopes such state to the stream
        (OnceAsync in per-execution state, hash_join.rs:84), we scope it
        by resetting before each re-execution."""

    def reset_state_recursive(self) -> None:
        self.reset_state()
        for c in self.children():
            c.reset_state_recursive()

    # ---- display -------------------------------------------------------------
    def display_line(self) -> str:
        return self.name()

    def display_indent(self, show_metrics: bool = False) -> str:
        lines = []
        def walk(node: "ExecutionPlan", depth: int):
            line = "  " * depth + node.display_line()
            if show_metrics:
                s = node.metrics.summary()
                if s:
                    line += f", metrics=[{s}]"
            lines.append(line)
            for c in node.children():
                walk(c, depth + 1)
        walk(self, 0)
        return "\n".join(lines)

    def transform_up(self, f) -> "ExecutionPlan":
        new_children = [c.transform_up(f) for c in self.children()]
        node = self.with_children(new_children) if new_children else self
        return f(node)

    def __repr__(self):
        return self.display_indent()


class _PartitionError:
    def __init__(self, exc: BaseException):
        self.exc = exc


_END_OF_PARTITION = object()


def parallel_partition_stream(plan: ExecutionPlan, ctx: TaskContext,
                              ordered: bool = True,
                              queue_depth: int = 4) -> Iterator[Batch]:
    """Pull every partition concurrently on its own thread (reference:
    RecordBatchReceiverStream, stream.rs:212 — one spawned task per
    partition feeding a channel). numpy kernels release the GIL, so
    partition work genuinely overlaps across host cores.

    ordered=True yields partition 0's batches before partition 1's
    (deterministic output order) while all partitions compute
    concurrently — materializing operators do their work before the
    first yield, so ordered draining costs almost no overlap. The
    per-partition queues are bounded; abandoned consumers (LIMIT) set a
    cancel flag that unblocks producer threads.
    """
    import queue
    import threading

    n = plan.output_partitioning().n
    if ordered:
        qs = [queue.Queue(maxsize=queue_depth) for _ in range(n)]
    else:
        shared: "queue.Queue" = queue.Queue(maxsize=n * queue_depth)
        qs = [shared] * n
    cancel = threading.Event()

    def pull(p: int) -> None:
        q = qs[p]

        def put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for b in plan.execute(p, ctx):
                if not put(b):
                    return
            put(_END_OF_PARTITION)
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            put(_PartitionError(e))

    threads = [threading.Thread(target=pull, args=(p,), daemon=True)
               for p in range(n)]
    for t in threads:
        t.start()
    try:
        if ordered:
            for p in range(n):
                while True:
                    item = qs[p].get()
                    if item is _END_OF_PARTITION:
                        break
                    if isinstance(item, _PartitionError):
                        raise item.exc
                    yield item
        else:
            finished = 0
            while finished < n:
                item = qs[0].get()
                if item is _END_OF_PARTITION:
                    finished += 1
                    continue
                if isinstance(item, _PartitionError):
                    raise item.exc
                yield item
    finally:
        cancel.set()


def execute_stream(plan: ExecutionPlan, ctx: TaskContext) -> Iterator[Batch]:
    """Single merged stream over all partitions
    (reference: lib.rs:730 — wraps in CoalescePartitionsExec)."""
    n = plan.output_partitioning().n
    if n > 1 and ctx.config.get("datafusion.execution.parallel_host_streams"):
        yield from parallel_partition_stream(plan, ctx, ordered=True)
        return
    for p in range(n):
        yield from plan.execute(p, ctx)


def collect(plan: ExecutionPlan, ctx: Optional[TaskContext] = None) -> List[Batch]:
    """Execute and gather all partitions (reference: lib.rs:714)."""
    ctx = ctx or TaskContext()
    return [b for b in execute_stream(plan, ctx) if b.num_rows > 0]


def collect_batch(plan: ExecutionPlan, ctx: Optional[TaskContext] = None) -> Batch:
    batches = collect(plan, ctx)
    if not batches:
        return Batch.empty(plan.schema())
    return concat_batches(plan.schema(), batches)
