"""A later change adds a cell and a metric as new files and new entries;
the harness finds them by name, with no edit to a file that is there."""
import json
import shutil

from portbench import harness
from portbench.tests.common import ROOT


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp_path / "portbench"
    (pb / "workloads" / "tpch-sf10-q6-only.json").write_text(json.dumps({
        "config": "tpch-sf10", "queries": ["q6", "q1"], "trace_chunk": 4,
        "limits": {"wrong_cells": 0}}))
    (pb / "metrics" / "queries_traced.py").write_text(
        "def read(trace):\n    return float(trace['queries'])\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tpch-sf10-q6-only", "config": "tpch-sf10",
                           "traffic": "q6-only", "chips": 1, "why": "a test"})
    m["per_layer"].append({
        "name": "queries_traced", "unit": "queries", "better": "higher",
        "source": "program_counter", "layer": "harness",
        "moves": "queries_per_s", "workloads": ["tpch-sf10-q6-only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.Cell("tpch-sf10-q6-only", tmp_path)
    assert set(cell.sql) == {"q6", "q1"}
    assert set(cell.readers) == {"queries_traced"}
    r = harness.run("tpch-sf10-q6-only", 9, 0.5, True, "cpu", scale=2e-4,
                    root=tmp_path, log=lambda *a: None)
    assert r["correct"]
    # one warm-up step, not kept, in each cycle of 1 + 4 steps
    warmups = -(-r["attempted"] // 5)
    assert r["metrics"]["queries_traced"]["value"] == r["attempted"] - warmups
    assert r["metrics"]["queries_traced"]["unit"] == "queries"
