"""Test helper: the same data and expressions as objects of each package.

The port keeps its own copy of the JAX package's host layers, so its
`Column`, `Batch`, `DataType` and expression classes are other classes
than the JAX package's, and the port's lowering `isinstance`-checks its
own. A test builds its inputs once with the JAX package's classes (from
seeded numpy arrays) and hands the port `twin(x)`: the same numpy arrays
and the same fields, built with the port's classes.
"""
import enum
import importlib

import numpy as np

import datafusion_tpu as df
import datafusion_tpu_torch as dft

_REF, _PORT = "datafusion_tpu", "datafusion_tpu_torch"


def _port_class(cls):
    mod = importlib.import_module(_PORT + cls.__module__[len(_REF):])
    out = mod
    for part in cls.__qualname__.split("."):
        out = getattr(out, part)
    return out


def _slots(cls):
    for c in cls.__mro__:
        s = c.__dict__.get("__slots__", ())
        yield from ((s,) if isinstance(s, str) else s)


def twin(obj, _memo=None):
    """`obj` (a JAX-package object, or a container of them) rebuilt with the
    port's classes. Columns are made anew from their host arrays, so each
    has the port's own never-recycled uid."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, (list, tuple)):
        out = type(obj)(twin(x, memo) for x in obj)
    elif isinstance(obj, dict):
        out = {twin(k, memo): twin(v, memo) for k, v in obj.items()}
    elif not type(obj).__module__.startswith(_REF + "."):
        return obj                     # numpy arrays, numbers, strings, None
    elif isinstance(obj, enum.Enum):
        out = _port_class(type(obj))(obj.value)
    elif isinstance(obj, df.Column):
        out = dft.Column(twin(obj.dtype, memo), obj.data_host(),
                         obj.validity_host(), twin(obj.dictionary, memo))
    else:
        out = object.__new__(_port_class(type(obj)))
        memo[id(obj)] = out
        for k, v in getattr(obj, "__dict__", {}).items():
            object.__setattr__(out, k, twin(v, memo))
        for k in _slots(type(obj)):
            if k != "__dict__" and hasattr(obj, k):
                object.__setattr__(out, k, twin(getattr(obj, k), memo))
    memo[id(obj)] = out
    return out


def register_both(port, ref, name, batch):
    """Register the JAX-package `batch` as table `name` in the JAX
    package's context `ref` and its twin in the port's context `port`."""
    ref.register_table(name, df.MemTable(batch.schema, [[batch]]))
    pb = twin(batch)
    port.register_table(name, dft.MemTable(pb.schema, [[pb]]))


def hits_batch(pkg, n, seed=0):
    """ClickBench `hits` as `register_hits` registers it
    (`datafusion_tpu/clickbench/workload.py:126`), built with the classes
    of `pkg` (`datafusion_tpu` or `datafusion_tpu_torch`)."""
    from datafusion_tpu.clickbench.workload import generate_hits
    dt, Column = pkg.dt, pkg.Column
    Dictionary = importlib.import_module(pkg.__name__ + ".common.column") \
        .Dictionary
    cols, fields = [], []
    for name, v in generate_hits(n, seed).items():
        if isinstance(v, tuple) and v[0] == "dict":
            _tag, values, codes = v
            order = np.argsort(values.astype(str), kind="stable")
            rank = np.empty(len(order), np.int32)
            rank[order] = np.arange(len(order), dtype=np.int32)
            cols.append(Column(dt.STRING, rank[codes], None,
                               Dictionary(values[order])))
            fields.append(pkg.Field(name, dt.STRING, False))
        elif v.dtype == object:
            uniq, inv = np.unique(v.astype(str), return_inverse=True)
            cols.append(Column(dt.STRING, inv.astype(np.int32), None,
                               Dictionary(uniq.astype(object))))
            fields.append(pkg.Field(name, dt.STRING, False))
        else:
            t = dt.INT64 if v.dtype == np.int64 else \
                dt.INT32 if v.dtype == np.int32 else dt.FLOAT64
            cols.append(Column(t, v, None))
            fields.append(pkg.Field(name, t, False))
    return pkg.Batch(pkg.Schema(fields), cols, n)


def register_hits_both(port, ref, n, seed=0):
    for pkg, ctx in ((df, ref), (dft, port)):
        b = hits_batch(pkg, n, seed)
        ctx.register_table("hits", pkg.MemTable(b.schema, [[b]]))


def register_tpch_both(port, ref, sf=0.01, seed=0):
    """TPC-H through each package's own `register_tpch`, from one seed."""
    from datafusion_tpu.tpch.datagen import register_tpch as ref_tpch
    from datafusion_tpu_torch.tpch.datagen import register_tpch as port_tpch
    ref_tpch(ref, sf=sf, seed=seed)
    port_tpch(port, sf=sf, seed=seed)
