"""The port's command line (`python -m datafusion_tpu_torch`,
`datafusion_tpu_torch/cli.py`) against the JAX package's: the same
statements print the same table, CSV and JSON from both, by `-c` and by
`-f`, with and without a memory limit; the command runs with `jax` and
`datafusion_tpu` blocked; and it takes the card unless it is given the
CPU, so here the bare command raises."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from datafusion_tpu.cli import main as ref_main
from datafusion_tpu_torch.cli import _split_statements, main

ROOT = pathlib.Path(__file__).resolve().parent.parent
CREATE = ("CREATE TABLE t AS SELECT value % 8 AS g, value AS v, "
          "value * 0.5 AS f FROM generate_series(1, 2000)")
SELECT = ("SELECT g, count(*) AS c, sum(v) AS s, avg(f) AS a FROM t "
          "GROUP BY g ORDER BY g")
SCRIPT = (f"{CREATE};\nSELECT 'a;b' AS x, 2 AS y;\n"
          "SHOW TABLES;\nSELECT g, v FROM t WHERE v < 20 ORDER BY v")


def test_cli_statement_split():
    stmts = _split_statements("SELECT 1; SELECT 'a;b'; \nSELECT 2")
    assert len(stmts) == 3
    assert stmts[1] == "SELECT 'a;b'"


def _printed(fn, argv, capsys):
    assert fn(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["table", "csv", "json"])
@pytest.mark.parametrize("how", ["-c", "-f", "--memory-limit"])
def test_output_matches_jax_package(fmt, how, tmp_path, capsys):
    if how == "-f":
        path = tmp_path / "script.sql"
        path.write_text(SCRIPT)
        args = ["-f", str(path), "-c", SELECT]
    else:
        args = ["-c", CREATE, "-c", SELECT]
        if how == "--memory-limit":
            args += ["--memory-limit", str(1 << 30)]
    got = _printed(main, ["--device", "cpu", "--format", fmt] + args, capsys)
    want = _printed(ref_main, ["--format", fmt] + args, capsys)
    assert got == want
    assert "250" in got             # each of the 8 groups holds 250 rows


def test_explain_runs_on_the_device_path(capsys):
    out = _printed(main, ["--device", "cpu", "--format", "csv", "-c", CREATE,
                          "-c", "EXPLAIN " + SELECT], capsys)
    assert "TorchGroupAggregateExec: gby=[g]" in out
    assert "device=cpu" in out


BLOCK = """
import sys
for _name in ("jax", "datafusion_tpu"):
    sys.modules[_name] = None
"""


def test_command_runs_without_jax(tmp_path):
    """`python -m datafusion_tpu_torch --device cpu -c ...` with `jax` and
    `datafusion_tpu` blocked (a `sitecustomize` that the interpreter loads
    first)."""
    (tmp_path / "sitecustomize.py").write_text(BLOCK)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    proc = subprocess.run(
        [sys.executable, "-m", "datafusion_tpu_torch", "--device", "cpu",
         "--format", "csv", "-c", "SELECT 1 AS one, 'x' AS s"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines() == ["one,s", "1,x"]


def test_bare_command_takes_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bare command runs on it")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        main(["-c", "SELECT 1"])
