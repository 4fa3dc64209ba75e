"""TPC-H workload: schema, data generator, the 22 queries.

Reference parity: `benchmarks/src/tpch/mod.rs` (table schemas, query
loading) and `test-utils/src/tpch.rs`. The generator approximates dbgen's
distributions (uniform keys, exponential-ish prices, date ranges
1992-1998) with referential integrity; it is seeded and deterministic so
results are reproducible, but it is NOT dbgen-bit-identical.
"""
from .datagen import generate_tpch, register_tpch  # noqa: F401
from .queries import QUERIES, query  # noqa: F401
