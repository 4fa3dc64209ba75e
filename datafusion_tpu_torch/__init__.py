"""datafusion_tpu_torch — the PyTorch/CUDA port of datafusion_tpu.

The port stands alone: it imports `torch` and never `jax`, and nothing of
the JAX package. It keeps its own copy of the neutral host layers (SQL
front end, logical optimizer, catalog, data sources, numpy host
operators) at the reference's relative paths, and owns the device half:
column residency (`common/column.py`), expression programs
(`device/lower.py`), the group-aggregate, join-chain, sort and window
kernels (`device/groupby.py`, `device/join_chain.py`,
`physical/plan/device_sort.py`, `device/window.py`, `csrc/*.cu`) and
their physical operators and rules.

    import torch, datafusion_tpu_torch as dft
    ctx = dft.SessionContext(torch.device("cuda"))
    ctx.register_table("lineitem", dft.MemTable(batch.schema, [[batch]]))
    ctx.sql("SELECT ... GROUP BY ...").to_pydict()
    dft.launch_counts()    # {"fused_dense_aggregate": N, ...}
"""
from __future__ import annotations

__version__ = "0.1.0"

from .api.context import SessionConfig, SessionContext  # noqa: F401,E402
from .api.dataframe import DataFrame  # noqa: F401,E402
from .catalog import (CatalogProvider, MemoryCatalogProvider,  # noqa: F401,E402
                      MemorySchemaProvider, SchemaProvider)
from .common import (Batch, Column, ConfigOptions,  # noqa: F401,E402
                     DataFusionError, DataType, Field, ScalarValue, Schema,
                     dt)
from .datasource import MemTable, StreamTable, TableProvider  # noqa: F401,E402
from .device import groupby as _groupby  # noqa: F401,E402  registers kernels
from .device import join_chain as _join_chain  # noqa: F401,E402
from .device import window as _window  # noqa: F401,E402  (and device_sort)
from .expr.expr_fns import col, lit  # noqa: F401,E402
from .kernels import (KERNELS, launch_counts,  # noqa: F401,E402
                      reset_launch_counts)
from .sql.unparser import expr_to_sql, plan_to_sql  # noqa: F401,E402

__all__ = ["SessionContext", "SessionConfig", "DataFrame", "MemTable",
           "StreamTable", "TableProvider", "CatalogProvider",
           "SchemaProvider", "MemoryCatalogProvider", "MemorySchemaProvider",
           "Batch", "Column", "ConfigOptions", "DataFusionError", "DataType",
           "Field", "ScalarValue", "Schema", "dt", "col", "lit",
           "plan_to_sql", "expr_to_sql", "KERNELS", "launch_counts",
           "reset_launch_counts"]
