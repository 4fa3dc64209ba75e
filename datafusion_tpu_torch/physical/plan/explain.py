"""ExplainExec / AnalyzeExec.

Reference parity: `explain.rs:100`, `analyze.rs:42` — EXPLAIN renders plan
text; EXPLAIN ANALYZE executes the plan then renders it annotated with the
metrics tree.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from ...common import dt
from ...common.batch import Batch
from ...common.column import Column
from ...common.schema import Field, Schema
from ...runtime import TaskContext
from .base import ExecutionPlan, Partitioning

EXPLAIN_SCHEMA = Schema([Field("plan_type", dt.STRING, False),
                         Field("plan", dt.STRING, False)])


def _string_batch(rows: List[Tuple[str, str]]) -> Batch:
    a = np.array([r[0] for r in rows], dtype=object)
    b = np.array([r[1] for r in rows], dtype=object)
    from ...common.column import Dictionary
    c0, v0, d0 = Dictionary.build(a)
    c1, v1, d1 = Dictionary.build(b)
    return Batch(EXPLAIN_SCHEMA,
                 [Column(dt.STRING, c0, v0, d0), Column(dt.STRING, c1, v1, d1)],
                 len(rows))


class ExplainExec(ExecutionPlan):
    def __init__(self, rows: List[Tuple[str, str]]):
        super().__init__()
        self.rows = rows

    def schema(self):
        return EXPLAIN_SCHEMA

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        yield _string_batch(self.rows)

    def display_line(self):
        return "ExplainExec"


class AnalyzeExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, verbose: bool = False):
        super().__init__()
        self.input = input
        self.verbose = verbose

    def schema(self):
        return EXPLAIN_SCHEMA

    def children(self):
        return [self.input]

    def with_children(self, c):
        return AnalyzeExec(c[0], self.verbose)

    def execute(self, partition: int, ctx: TaskContext) -> Iterator[Batch]:
        import time
        t0 = time.perf_counter()
        n = self.input.output_partitioning().n
        for p in range(n):
            for _ in self.input.execute(p, ctx):
                pass
        elapsed = time.perf_counter() - t0
        text = self.input.display_indent(show_metrics=True)
        rows = [("Plan with Metrics", text),
                ("Total Duration", f"{elapsed*1e3:.3f}ms")]
        yield _string_batch(rows)

    def display_line(self):
        return "AnalyzeExec"


def _node_line(node) -> str:
    return node.display_line() if hasattr(node, "display_line") \
        else node._display_line()


def _node_children(node):
    if hasattr(node, "children"):
        return node.children()
    return list(node.inputs)


def display_graphviz(plan) -> str:
    """DOT digraph of a logical or physical plan (reference:
    display/graphviz.rs)."""
    lines = ["digraph {"]
    counter = [0]

    def walk(node) -> int:
        counter[0] += 1
        nid = counter[0]
        label = _node_line(node).replace('"', '\\"')
        lines.append(f'  {nid}[shape=box label="{label}"]')
        for c in _node_children(node):
            cid = walk(c)
            lines.append(f"  {nid} -> {cid} [arrowhead=none, "
                         f"arrowtail=normal, dir=back]")
        return nid

    walk(plan)
    lines.append("}")
    return "\n".join(lines)


def display_pgjson(plan) -> str:
    """Postgres-style EXPLAIN (FORMAT JSON) of a logical plan (reference:
    display/pg_json.rs)."""
    import json

    def walk(node) -> dict:
        out = {"Node Type": _node_line(node).split(":")[0]}
        kids = [walk(c) for c in _node_children(node)]
        if kids:
            out["Plans"] = kids
        return out

    return json.dumps([{"Plan": walk(plan)}])
