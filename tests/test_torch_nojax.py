"""The PyTorch port runs without JAX.

A fresh interpreter (this one has imported JAX already) blocks `jax`,
runs TPC-H Q1, TPC-H Q18's subquery (the hash path with a fused HAVING)
and ClickBench Q16 (the hash path with a fused top-k) through the port on
the CPU and compares them with the JAX package's host path, which needs
no JAX either. It also checks that none
of the JAX package's device or multi-device modules was loaded, and that
asking for CUDA where there is none raises.
"""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None
import numpy as np
import torch
import datafusion_tpu_torch as dft
import bench
import datafusion_tpu as df

batch = bench.make_lineitem(20_000, seed=2)
port = dft.SessionContext(torch.device("cpu"))
port.register_table("lineitem", dft.MemTable(batch.schema, [[batch]]))
host = df.SessionContext()
host.config.set("datafusion.tpu.device_aggregate", False)
host.register_table("lineitem", df.MemTable(batch.schema, [[batch]]))
got = port.sql(bench.Q1).to_pydict()
assert got == host.sql(bench.Q1).to_pydict(), got
assert len(got["l_returnflag"]) == 4
plan = "\n".join(port.sql("EXPLAIN " + bench.Q1).to_pydict()["plan"])
assert "TorchGroupAggregateExec" in plan, plan
from datafusion_tpu.clickbench.workload import QUERIES as CB, register_hits
from datafusion_tpu.tpch.datagen import register_tpch
for c in (port, host):
    register_tpch(c, sf=0.01)
    register_hits(c, n=20_000)
q18s = ("select l_orderkey from lineitem group by l_orderkey "
        "having sum(l_quantity) > 300 order by l_orderkey")
got = port.sql(q18s).to_pydict()
assert got == host.sql(q18s).to_pydict() and got["l_orderkey"], got
got, want = port.sql(CB[16]).to_pydict(), host.sql(CB[16]).to_pydict()
assert got["count(*)"] == want["count(*)"], (got, want)
for q, fused in ((q18s, "having="), (CB[16], "topk=[count(*) DESC LIMIT 10]")):
    plan = "\n".join(port.sql("EXPLAIN " + q).to_pydict()["plan"])
    assert "TorchGroupAggregateExec" in plan and fused in plan, plan
loaded = sorted(m for m in sys.modules
                if m.startswith(("datafusion_tpu.device",
                                 "datafusion_tpu.parallel"))
                or (m.startswith("jax") and sys.modules[m] is not None))
assert not loaded, loaded
if not torch.cuda.is_available():
    try:
        dft.SessionContext(torch.device("cuda"))
    except RuntimeError:
        pass
    else:
        raise AssertionError("a CUDA context without CUDA did not raise")
print("OK")
"""


def test_port_runs_q1_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def test_port_does_not_load_jax_where_it_is_installed():
    """Without blocking anything: importing and running the port leaves
    JAX unloaded, though `datafusion_tpu/__init__.py` would import it."""
    script = SCRIPT.replace('sys.modules["jax"] = None', "")
    script += 'assert "jax" not in sys.modules, "JAX was imported"\n'
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in (ROOT / "datafusion_tpu_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += [str(ROOT / "chip_smoke.py")] \
        if pattern.search((ROOT / "chip_smoke.py").read_text()) else []
    assert not offenders, offenders
