"""Plan serialization in the port (`datafusion_tpu_torch/proto/`) against
the JAX package's (`datafusion_tpu/proto/`).

Every case of `test_proto.py` runs through both packages on the same
tables: the port's logical-plan JSON must be the JAX package's string for
string, and the rows of the plan read back the same. The physical plans
of the 22 TPC-H queries at SF 0.01 (each package's own `register_tpch`,
one seed) ship as the reference ships them: a device exec as its host
`fallback`, so the port's dict holds no `Torch*` exec, equals the JAX
package's dict where both serialize, and raises the reference's
`NotImplementedError` where the reference raises (a join).
"""
import json

import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.proto import plan_to_json as ref_to_json
from datafusion_tpu.proto.physical import phys_to_dict as ref_phys_to_dict
from datafusion_tpu_torch.api.dataframe import DataFrame
from datafusion_tpu_torch.parallel.pod import LocalPod
from datafusion_tpu_torch.physical.plan.base import collect_batch
from datafusion_tpu_torch.physical.plan.device_aggregate import (
    TorchDeviceExec)
from datafusion_tpu_torch.physical.plan.sort import SortExec
from datafusion_tpu_torch.proto import plan_from_json, plan_to_json
from datafusion_tpu_torch.proto.physical import phys_from_dict, phys_to_dict
from datafusion_tpu_torch.tpch.queries import QUERIES as TPCH
from test_proto import QUERIES
from torch_twin import register_tpch_both

CPU = torch.device("cpu")
T = {"a": np.array([1, 2, 3]), "s": np.array(["a", "bb", "abc"])}


def _contexts():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    for c in (port, ref):
        c.config.options.set("datafusion.catalog.information_schema", True)
        c.register_arrays("t", T)
    return port, ref


@pytest.fixture(scope="module")
def tctx():
    return _contexts()


@pytest.fixture(scope="module")
def tpch():
    port, ref = dft.SessionContext(CPU), df.SessionContext()
    register_tpch_both(port, ref, sf=0.01)
    return port, ref


@pytest.mark.parametrize("q", QUERIES)
def test_roundtrip_matches_jax_package(tctx, q):
    port, ref = tctx
    frame = port.sql(q)
    js = plan_to_json(frame.plan)
    assert js == ref_to_json(ref.sql(q).plan)
    plan2 = plan_from_json(js, port)
    assert frame.plan.display() == plan2.display()
    got = DataFrame(port, plan2).to_pydict()
    assert got == frame.to_pydict() == ref.sql(q).to_pydict()


def test_roundtrip_optimized_matches_jax_package(tctx):
    port, ref = tctx
    q = "SELECT s, sum(a) FROM t WHERE a > 0 GROUP BY s"
    opt = port.sql(q).optimized_plan()
    js = plan_to_json(opt)
    assert js == ref_to_json(ref.sql(q).optimized_plan())
    assert opt.display() == plan_from_json(js, port).display()


def _execs(plan):
    yield plan
    for c in plan.children():
        yield from _execs(c)


def _ship(plan, ctx, to_dict=phys_to_dict):
    """The plan's dict, or the message of the NotImplementedError that
    serializing it raises."""
    try:
        return to_dict(plan, LocalPod._table_names(ctx))
    except NotImplementedError as e:
        return f"NotImplementedError: {e}"


@pytest.mark.parametrize("q", sorted(TPCH))
def test_tpch_physical_roundtrip(tpch, q):
    port, ref = tpch
    plan = port.sql(TPCH[q]).create_physical_plan()
    d = _ship(plan, port)
    want = _ship(ref.sql(TPCH[q]).create_physical_plan(), ref,
                 ref_phys_to_dict)
    assert d == want
    if isinstance(d, str):
        assert d.startswith("NotImplementedError: physical plan "
                            "serialization for ")
        return
    assert any(isinstance(n, TorchDeviceExec) for n in _execs(plan))
    assert "Torch" not in json.dumps(d)
    back = phys_from_dict(json.loads(json.dumps(d)), port)
    assert not any(isinstance(n, TorchDeviceExec) for n in _execs(back))
    # the receiving context decides where a shipped sort runs
    assert all(n.device == port.device for n in _execs(back)
               if isinstance(n, SortExec))
    tctx = port.task_context()
    assert collect_batch(back, tctx).to_pydict() == \
        collect_batch(plan, tctx).to_pydict()


def test_mesh_exec_ships_as_its_fallback(tpch):
    """A TorchDistributedAggregateExec (a 4-shard mesh) ships as the same
    host tree as the single-device aggregate, which is the JAX package's
    dict."""
    port, ref = tpch
    meshed = dft.SessionContext(CPU)
    meshed.sql("SET datafusion.tpu.mesh_devices = 4")
    for name in ("lineitem",):
        meshed.register_table(name, port.get_table(name))
    plan = meshed.sql(TPCH[1]).create_physical_plan()
    assert any(type(n).__name__ == "TorchDistributedAggregateExec"
               for n in _execs(plan))
    d = _ship(plan, meshed)
    assert d == _ship(ref.sql(TPCH[1]).create_physical_plan(), ref,
                      ref_phys_to_dict)
    back = phys_from_dict(d, meshed)
    assert collect_batch(back, meshed.task_context()).to_pydict() == \
        port.sql(TPCH[1]).to_pydict()
