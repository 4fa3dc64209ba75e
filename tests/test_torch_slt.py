"""The sqllogictest corpus through the PyTorch port.

Every file of `tests/slt/` and `tests/slt/ref/` runs through the port's own
runner (`datafusion_tpu_torch/slt.py`, a copy of the reference runner whose
session is `dft.SessionContext(cpu)`), one case per file, with
`lenient_errors` for the ported corpus as `tests/test_slt.py` runs it. On
the CPU the port's device paths run their kernels' plain versions, so the
corpus is a parity net for every expression the port lowers.

One record kind differs by design: `SHOW ALL` and `SHOW ALL VERBOSE` of
`ref/information_schema.slt` list the engine's `datafusion.tpu.*` options,
and the port keeps only those it reads (`datafusion_tpu_torch/common/
config.py`). Those two records are held to the reference's rows for every
other option and to the port's own options for `datafusion.tpu.*`.
"""
import glob
import os
import re

import pytest

from datafusion_tpu_torch.common.config import _OPTIONS
from datafusion_tpu_torch.slt import _FILE_SETUP, SltRunner

SLT_DIR = os.path.join(os.path.dirname(__file__), "slt")
FILES = sorted(glob.glob(os.path.join(SLT_DIR, "*.slt")))
REF_FILES = sorted(glob.glob(os.path.join(SLT_DIR, "ref", "*.slt")))

_TPU = "datafusion.tpu."
_SHOW_ALL = re.compile(r"^(SHOW ALL( VERBOSE)?)\n----\n(.*?)(?:\n\n|\Z)",
                       re.M | re.S)


def _cell(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return "NULL" if v is None else str(v)


def _port_show_all(text: str) -> str:
    """`text` with the expected rows of each SHOW ALL record's
    `datafusion.tpu.*` options replaced by the port's own."""
    def repl(m):
        verbose = m.group(2) is not None
        rows = [r for r in m.group(3).split("\n") if not r.startswith(_TPU)]
        for key, default, _typ, doc in _OPTIONS:
            if key.startswith(_TPU):
                rows.append(f"{key} {_cell(default)}" +
                            (f" {doc}" if verbose else ""))
        return f"{m.group(1)}\n----\n" + "\n".join(rows) + "\n\n"
    return _SHOW_ALL.sub(repl, text)


def _run(path: str, lenient: bool) -> int:
    with open(path) as f:
        text = f.read()
    if os.path.basename(path) == "information_schema.slt":
        text = _port_show_all(text)
    runner = SltRunner(lenient_errors=lenient,
                       base_dir=os.path.dirname(os.path.abspath(path)))
    setup = _FILE_SETUP.get(os.path.basename(path))
    if setup is not None:
        setup(runner.ctx)
    return runner.run_text(text, path)


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.basename(f) for f in FILES])
def test_slt_file_on_the_port(path):
    assert _run(path, lenient=False) > 0


@pytest.mark.parametrize("path", REF_FILES,
                         ids=[os.path.basename(f) for f in REF_FILES])
def test_ref_slt_file_on_the_port(path):
    assert _run(path, lenient=True) > 0


def test_show_all_holds_only_the_tpu_rows_to_the_port():
    path = os.path.join(SLT_DIR, "ref", "information_schema.slt")
    with open(path) as f:
        text = f.read()
    ported = _port_show_all(text)
    old = _SHOW_ALL.findall(text)
    new = _SHOW_ALL.findall(ported)
    assert len(old) == len(new) == 2
    for (_h, _v, was), (_h2, _v2, now) in zip(old, new):
        keep = [r for r in was.split("\n") if not r.startswith(_TPU)]
        assert [r for r in now.split("\n") if not r.startswith(_TPU)] == keep
        assert len(keep) > 60


_AGG100 = """CREATE EXTERNAL TABLE aggregate_test_100 (
  c1 VARCHAR NOT NULL, c2 TINYINT NOT NULL, c3 SMALLINT NOT NULL,
  c4 SMALLINT, c5 INT, c6 BIGINT NOT NULL, c7 SMALLINT NOT NULL,
  c8 INT NOT NULL, c9 BIGINT UNSIGNED NOT NULL, c10 VARCHAR NOT NULL,
  c11 FLOAT NOT NULL, c12 DOUBLE NOT NULL, c13 VARCHAR NOT NULL)
STORED AS CSV LOCATION '{path}' OPTIONS ('format.has_header' 'true')"""


@pytest.mark.parametrize("sql", [
    "SELECT avg(sqrt(c11)) a FROM aggregate_test_100",
    "SELECT c2, sum(sqrt(c11)) a FROM aggregate_test_100 GROUP BY c2 "
    "ORDER BY c2",
])
def test_sqrt_aggregate_takes_the_device_path(sql):
    """`sqrt` lowers, so the port's aggregate stays on its device path and
    sums the float32 square roots in float64, as the JAX package's device
    path does (the host path would sum them in float32): the values equal
    the JAX package's to its printed digits, 0.658440848589 for the avg."""
    import torch

    import datafusion_tpu as df
    import datafusion_tpu_torch as dft
    from datafusion_tpu_torch.physical.plan.device_aggregate import (
        TorchGroupAggregateExec)
    from datafusion_tpu_torch.slt import _rows_to_lines as port_lines
    from datafusion_tpu.slt import _rows_to_lines as ref_lines

    create = _AGG100.format(path=os.path.join(
        SLT_DIR, "ref", "data", "aggregate_test_100.csv"))
    port, ref = dft.SessionContext(torch.device("cpu")), df.SessionContext()
    port.sql(create)
    ref.sql(create)
    got = port_lines(port.sql(sql).collect_batch(), "RR")
    want = ref_lines(ref.sql(sql).collect_batch(), "RR")
    assert got == want
    if "avg" in sql:
        assert got == ["0.658440848589"]

    def walk(n):
        yield n
        for c in n.children():
            yield from walk(c)
    from datafusion_tpu_torch.physical.plan.base import collect_batch
    plan = port.sql(sql).create_physical_plan()
    (ex,) = [n for n in walk(plan) if isinstance(n, TorchGroupAggregateExec)]
    assert port_lines(collect_batch(plan, port.task_context()), "RR") == got
    assert ex.fallbacks == 0
