"""Substrait interchange in the port (`datafusion_tpu_torch/substrait/`)
against the JAX package's: every case of `test_substrait.py` on the same
tables gives the same Substrait JSON from both packages, and the plan the
port reads back gives the JAX package's rows."""
import json

import numpy as np
import pytest
import torch

import datafusion_tpu as df
import datafusion_tpu_torch as dft
from datafusion_tpu.common.errors import NotImplementedError_ as RefNIE
from datafusion_tpu.substrait import plan_to_substrait as ref_to_substrait
from datafusion_tpu.substrait import substrait_to_plan as ref_to_plan
from datafusion_tpu_torch.api.dataframe import DataFrame
from datafusion_tpu_torch.common.errors import NotImplementedError_
from datafusion_tpu_torch.substrait import (plan_to_substrait,
                                            substrait_to_plan)
from test_substrait import QUERIES, _rows


@pytest.fixture(scope="module")
def st_ctx():
    rng = np.random.default_rng(5)
    t = {"a": rng.integers(0, 6, 40), "b": rng.integers(-10, 50, 40),
         "s": rng.choice(["ab", "cd", "ax"], 40).astype(object)}
    u = {"a": rng.integers(0, 6, 25), "d": rng.integers(-5, 20, 25)}
    port, ref = dft.SessionContext(torch.device("cpu")), df.SessionContext()
    for c in (port, ref):
        c.register_arrays("t", t)
        c.register_arrays("u", u)
    return port, ref


def _both(st_ctx, sql):
    port, ref = st_ctx
    proto = plan_to_substrait(port.sql(sql).logical_plan())
    assert json.dumps(proto) == json.dumps(
        ref_to_substrait(ref.sql(sql).logical_plan()))
    return proto


@pytest.mark.parametrize("sql", QUERIES)
def test_roundtrip_matches_jax_package(st_ctx, sql):
    port, ref = st_ctx
    proto = json.loads(json.dumps(_both(st_ctx, sql)))
    plan2 = substrait_to_plan(proto, port)
    got = _rows(DataFrame(port, plan2).collect_batch())
    assert got == _rows(ref.sql(sql).collect_batch())
    assert got == _rows(port.sql(sql).collect_batch())


def test_output_names_preserved(st_ctx):
    port, _ref = st_ctx
    proto = _both(st_ctx, "SELECT a AS x, sum(b) AS total FROM t GROUP BY a")
    plan2 = substrait_to_plan(proto, port)
    assert [f.name for f in plan2.schema.fields] == ["x", "total"]


def test_version_and_extensions_present(st_ctx):
    proto = _both(st_ctx, "SELECT a + 1 FROM t")
    assert proto["version"]["producer"] == "datafusion-tpu"
    names = [e["extensionFunction"]["name"] for e in proto["extensions"]]
    assert "add" in names


@pytest.mark.parametrize("sql", [
    "SELECT a, row_number() OVER (ORDER BY b) FROM t",
    "SELECT a FROM t WHERE a IN (SELECT a FROM u)",
])
def test_unsupported_raises_where_the_jax_package_raises(st_ctx, sql):
    port, ref = st_ctx
    with pytest.raises(RefNIE) as want:
        ref_to_substrait(ref.sql(sql).logical_plan())
    with pytest.raises(NotImplementedError_) as got:
        plan_to_substrait(port.sql(sql).logical_plan())
    assert str(got.value) == str(want.value)


def test_reader_raises_where_the_jax_package_raises(st_ctx):
    port, ref = st_ctx
    proto = _both(st_ctx, "SELECT a FROM t")
    proto["relations"][0]["root"]["input"] = {"exchange": {}}
    with pytest.raises(RefNIE) as want:
        ref_to_plan(proto, ref)
    with pytest.raises(NotImplementedError_) as got:
        substrait_to_plan(proto, port)
    assert str(got.value) == str(want.value)
