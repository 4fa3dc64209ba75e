"""The PyTorch port stands alone.

A fresh interpreter (this one has imported JAX already) blocks `jax`, the
JAX package `datafusion_tpu` with every module under it, and `bench`, then
runs through the port on the CPU: TPC-H Q1 (the dense path), Q18's
subquery (the hash path with a fused HAVING), ClickBench Q16 (the hash
path with a fused top-k), TPC-H Q3, Q4 and Q5 (fanout-1 join chains),
TPC-H Q2 and Q20 (row-returning join chains), Q13 (the count over a LEFT
join), TPC-H Q9 (date_part and decimal arithmetic in a five-hop chain) and
Q21 (SEMI and ANTI min/max membership), an ORDER BY ... LIMIT over lineitem (the radix sort) and a window
query (the device window evaluation), with the sort, window and
row-returning join thresholds at 1, and, in a second session on a
4-shard mesh, TPC-H Q1 (the all_gather aggregate) and lineitem x
partsupp (the partitioned join); then the command line's `-c` run and
Q1's logical plan through its JSON and back (`proto/`).
It prints the rows as JSON, and this process holds them against the JAX
package on the same seeded data (ClickBench's `UserID` drawn by each
package's own `generate_hits`). A second interpreter blocks nothing and
checks that running the port loads neither JAX nor the JAX package. The
last two tests read the port's sources: no import of `jax`,
`datafusion_tpu` or `bench` anywhere in `datafusion_tpu_torch/` or
`chip_smoke.py`.
"""
import ast
import contextlib
import io
import json
import pathlib
import re
import subprocess
import sys

import pytest

import datafusion_tpu as df
from datafusion_tpu.cli import main as cli_main
from datafusion_tpu.clickbench.workload import generate_hits
from datafusion_tpu.tpch.datagen import register_tpch
from datafusion_tpu.tpch.queries import QUERIES as TPCH
from datafusion_tpu_torch.clickbench.workload import QUERIES as CB

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "datafusion_tpu", "bench")
HITS_ROWS = 20_000
Q18_SUB = ("select l_orderkey from lineitem group by l_orderkey "
           "having sum(l_quantity) > 300 order by l_orderkey")
SORTED = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
          "order by l_extendedprice desc, l_orderkey limit 20")
WINDOW = ("select l_orderkey, l_linenumber, rank() over (partition by "
          "l_suppkey order by l_extendedprice desc) rk, sum(l_quantity) over "
          "(partition by l_suppkey order by l_shipdate rows between 2 "
          "preceding and current row) q3 from lineitem "
          "order by l_orderkey, l_linenumber limit 50")
DISTINCT = ('select count(distinct "UserID") u, count(*) c from hits')
J1 = ("select ps_suppkey, count(*) c, sum(ps_supplycost * l_quantity) cost "
      "from lineitem join partsupp on l_partkey = ps_partkey "
      "group by ps_suppkey order by ps_suppkey")
Q5D = TPCH[5].replace("as revenue", "as revenue, count(distinct o_custkey) "
                      "as customers")
MESH_JOIN = ("select ps_suppkey, count(*) c, sum(l_quantity) q from lineitem "
             "join partsupp on l_partkey = ps_partkey group by ps_suppkey "
             "order by ps_suppkey")
QUERIES = {"q1": TPCH[1], "q18_sub": Q18_SUB, "cb_q16": CB[16],
           "q3": TPCH[3], "q4": TPCH[4], "q5": TPCH[5], "q2": TPCH[2],
           "q20": TPCH[20], "q13": TPCH[13], "q9": TPCH[9], "q21": TPCH[21],
           "sorted": SORTED, "window": WINDOW, "distinct": DISTINCT,
           "j1": J1, "q5d": Q5D, "mesh_q1": TPCH[1], "mesh_join": MESH_JOIN}
# the exec each query must plan in the port, with what its display shows
PLANS = {"q1": ("TorchGroupAggregateExec", ""),
         "q18_sub": ("TorchGroupAggregateExec", "having="),
         "cb_q16": ("TorchGroupAggregateExec",
                    "topk=[count(*) DESC LIMIT 10]"),
         "q3": ("TorchJoinChainAggregateExec", "INNER["),
         "q4": ("TorchJoinChainAggregateExec", "LEFTSEMI["),
         "q5": ("TorchJoinChainAggregateExec", "INNER["),
         "q2": ("TorchJoinChainRowsExec", "INNER["),
         "q20": ("TorchJoinChainRowsExec", "LEFTSEMI["),
         "q13": ("LeftCountZeroFillExec", "left_key="),
         "q9": ("TorchJoinChainAggregateExec", "INNER["),
         "q21": ("TorchJoinChainAggregateExec", "filter="),
         "sorted": ("SortExec", "fetch=20"),
         "window": ("BoundedWindowExec", "rank()"),
         "distinct": ("TorchGroupAggregateExec", "count(DISTINCT"),
         "j1": ("TorchJoinAggregateExec", "on=["),
         "q5d": ("TorchJoinChainAggregateExec", "count(DISTINCT"),
         "mesh_q1": ("TorchDistributedAggregateExec", "(mesh=4)"),
         "mesh_join": ("TorchDistributedJoinAggregateExec", "(mesh=4)")}

BLOCK = r"""
import sys
BLOCKED = %r
for _name in BLOCKED:
    sys.modules[_name] = None


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Refuse())
""" % (BLOCKED,)

CLI = ["--format", "csv", "-c",
       "CREATE TABLE t AS SELECT value % 8 AS g, value AS v "
       "FROM generate_series(1, 1000)",
       "-c", "SELECT g, count(*) AS c, sum(v) AS s FROM t GROUP BY g "
       "ORDER BY g"]

SCRIPT = r"""
import contextlib
import io
import json
import sys

import torch

import datafusion_tpu_torch as dft
from datafusion_tpu_torch.api.dataframe import DataFrame
from datafusion_tpu_torch.cli import main as cli_main
from datafusion_tpu_torch.clickbench.workload import generate_hits
from datafusion_tpu_torch.proto import plan_from_json, plan_to_json
from datafusion_tpu_torch.tpch.datagen import register_tpch

queries, plans = json.loads(sys.argv[1]), json.loads(sys.argv[2])
port = dft.SessionContext(torch.device("cpu"))
port.sql("SET datafusion.tpu.device_sort_min_rows = 1")
port.sql("SET datafusion.tpu.device_window_min_rows = 1")
port.sql("SET datafusion.tpu.device_join_rows_min_spine = 1")
register_tpch(port, sf=0.01, seed=1)
port.register_arrays("hits", {
    "UserID": generate_hits(int(sys.argv[3]), 0)["UserID"]})
# the mesh: 4 shards of a LocalMesh, the partitioned join past 64 rows
meshed = dft.SessionContext(torch.device("cpu"))
meshed.sql("SET datafusion.tpu.mesh_devices = 4")
meshed.sql("SET datafusion.optimizer."
           "hash_join_single_partition_threshold_rows = 64")
register_tpch(meshed, sf=0.01, seed=1)


def execs(node):
    yield node
    for c in node.children():
        yield from execs(c)


rows = {}
for label, sql in queries.items():
    ctx = meshed if label.startswith("mesh") else port
    rows[label] = ctx.sql(sql).to_pydict()
    cls, shown = plans[label]
    found = [n for n in execs(ctx.sql(sql).create_physical_plan())
             if type(n).__name__ == cls]
    assert found and shown in found[0].display_line(), (label, found)
    ctx.sql(sql).collect()
    assert all(getattr(n, "fallbacks", 0) == 0 for n in found), label
    assert all(getattr(n, "device", port.device) == port.device
               for n in found), label
    assert all(getattr(n, "routes", [1]) for n in found), label
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli_main(["--device", "cpu"] + json.loads(sys.argv[4])) == 0
rows["cli"] = out.getvalue()
q1 = port.sql(queries["q1"])
q1_back = DataFrame(port, plan_from_json(plan_to_json(q1.plan), port))
assert q1_back.plan.display() == q1.plan.display()
rows["proto_q1"] = q1_back.to_pydict()
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None and
                m.split(".")[0] in ("jax", "datafusion_tpu", "bench"))
assert not loaded, loaded
if not torch.cuda.is_available():
    try:
        dft.SessionContext(torch.device("cuda"))
    except RuntimeError:
        pass
    else:
        raise AssertionError("a CUDA context without CUDA did not raise")
print(json.dumps(rows, default=str))
"""


def _run(script):
    proc = subprocess.run(
        [sys.executable, "-c", script, json.dumps(QUERIES),
         json.dumps(PLANS), str(HITS_ROWS), json.dumps(CLI)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _reference():
    host = df.SessionContext()
    register_tpch(host, sf=0.01, seed=1)
    host.register_arrays("hits", {
        "UserID": generate_hits(HITS_ROWS, 0)["UserID"]})
    want = {label: json.loads(json.dumps(host.sql(sql).to_pydict(),
                                         default=str))
            for label, sql in QUERIES.items()}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli_main(CLI) == 0
    want["cli"] = out.getvalue()
    return want


def _same(got, want):
    """Equal rows in order: strings (decimals and dates too) and integers
    exactly, floats within rel 1e-9 (the two packages sum in different
    orders)."""
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for a, b in zip(got[name], want[name]):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9), (name, a, b)
            else:
                assert a == b, (name, a, b)


def test_port_runs_without_jax_or_the_jax_package():
    got = _run(BLOCK + SCRIPT)
    want = _reference()
    assert got["cli"] == want["cli"]
    _same(got["proto_q1"], want["q1"])
    for label in QUERIES:
        if label == "cb_q16":
            # ties at the 10th count may pick other users: counts only
            assert got[label]["count(*)"] == want[label]["count(*)"]
        else:
            _same(got[label], want[label])
    assert got["q18_sub"]["l_orderkey"] and len(got["q1"]["l_returnflag"]) == 4
    assert got["q3"]["l_orderkey"] and got["q5"]["n_name"]
    assert got["q9"]["nation"] and got["q21"]["s_name"]
    assert len(got["sorted"]["l_orderkey"]) == 20
    assert len(got["window"]["rk"]) == 50


def test_port_does_not_load_jax_where_it_is_installed():
    """Without blocking anything: running the port leaves JAX and the JAX
    package unloaded (the script asserts it)."""
    got = _run(SCRIPT)
    assert len(got["q4"]["o_orderpriority"]) == 5


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in (ROOT / "datafusion_tpu_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += [str(ROOT / "chip_smoke.py")] \
        if pattern.search((ROOT / "chip_smoke.py").read_text()) else []
    assert not offenders, offenders


def _imports(path):
    """(line, module) of every import in `path`, relative ones resolved
    against the module's package."""
    package = list(path.relative_to(ROOT).parts[:-1])
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name, False
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                base = package[:max(len(package) - node.level + 1, 0)]
                mod = ".".join(base + ([mod] if mod else []))
            yield node.lineno, mod, bool(node.level)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Every import, at any depth (inside functions too), of every module
    of the port and of `chip_smoke.py`: none names `jax`, `datafusion_tpu`
    (bare or dotted) or `bench`, and no relative import climbs out of the
    port's package. The walk covers a counterpart of every module of the
    JAX package."""
    files = sorted((ROOT / "datafusion_tpu_torch").rglob("*.py"))
    port = {p.relative_to(ROOT / "datafusion_tpu_torch") for p in files}
    ref = {p.relative_to(ROOT / "datafusion_tpu")
           for p in (ROOT / "datafusion_tpu").rglob("*.py")}
    assert ref <= port, sorted(map(str, ref - port))
    offenders = []
    for path in files + [ROOT / "chip_smoke.py"]:
        for line, mod, relative in _imports(path):
            top = mod.split(".")[0]
            if top in BLOCKED or (relative and top != "datafusion_tpu_torch"):
                offenders.append(f"{path.relative_to(ROOT)}:{line}: {mod}")
    assert not offenders, offenders
