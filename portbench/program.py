"""What the benchmark takes from the program (`datafusion_tpu_torch`): the
session that runs SQL, the registration of generated tables, the launch
counters and the names of its CUDA kernels. Nothing else of the harness
imports the program."""
from __future__ import annotations

from pathlib import Path

import numpy as np


def session(device: str):
    """A session of the port on `device`, with its kernel library built
    or loaded from the port's own cache in the checkout when the device is
    the card."""
    import torch
    import datafusion_tpu_torch as dft
    ctx = dft.SessionContext(torch.device(device))
    if ctx.device.type == "cuda":
        from datafusion_tpu_torch import kernels
        kernels.library()
    return ctx


def register(ctx, tables: dict) -> None:
    """Register {table: {column: Col with host data}} as in-memory tables
    of one batch each, each column held as the program holds its type
    (a SMALLINT's values widened to the program's int32)."""
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.common.column import Dictionary
    types = {"int64": dft.dt.INT64, "int32": dft.dt.INT32,
             "int16": dft.dt.INT16, "date": dft.dt.DATE,
             "string": dft.dt.STRING}
    for name, cols in tables.items():
        fields, columns = [], []
        for cname, c in cols.items():
            dtype = dft.dt.decimal(15, c.scale) if c.kind == "decimal" \
                else types[c.kind]
            if c.kind == "string":
                columns.append(dft.Column(dtype, c.data, None, Dictionary(
                    np.array(c.values, dtype=object))))
            else:
                columns.append(dft.Column.from_numpy(c.data, dtype))
            fields.append(dft.Field(cname, dtype, False))
        schema = dft.Schema(fields)
        batch = dft.Batch(schema, columns, len(columns[0].data_host()))
        ctx.register_table(name, dft.MemTable(schema, [[batch]]))


def launches() -> int:
    """Kernel launches the program has counted so far."""
    import datafusion_tpu_torch as dft
    return sum(dft.launch_counts().values())


def csrc() -> Path:
    """The directory of the program's CUDA sources."""
    import datafusion_tpu_torch as dft
    return Path(dft.__file__).resolve().parent / "csrc"
