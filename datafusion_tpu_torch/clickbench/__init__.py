"""ClickBench-style workload: hits-like table + representative queries.

Reference parity: `benchmarks/src/clickbench.rs:41-65` (43 queries over the
`hits` table). The generator produces a seeded hits-like table with the
columns the query subset touches (high-cardinality group-bys, string
filters, LIMIT-sorts — the workload's signature shapes); queries are the
public ClickBench statements for those columns.
"""
from .workload import (QUERIES, decode_hits, generate_hits,  # noqa: F401
                       register_hits)
