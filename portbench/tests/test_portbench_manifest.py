"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the cells' files and each metric's `workloads` list."""
import json
import re

import pytest

from portbench.harness import quantity
from portbench.tests.common import CELLS, ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = ROOT / "portbench"


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_the_cells():
    assert [w["name"] for w in M["workloads"]] == list(CELLS)
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec = json.loads((PB / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert spec["config"] == w["config"]
        for q in spec["queries"]:
            assert (PB / "queries" / w["config"] / f"{q}.sql").is_file()
            assert (PB / "reference" / w["config"] / f"{q}.py").is_file()


def test_the_configurations():
    used = {w["config"] for w in M["workloads"]}
    assert {c["name"] for c in M["configs"]} == used
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert (PB / "configs" / f"{c['name']}.py").is_file()
        assert 1 <= len(c["source"]) <= 200


def reported_by(metric):
    return set(metric.get("workloads", [w["name"] for w in M["workloads"]]))


def test_the_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert {quantity(n) for n in e2e} == {"queries_per_s", "latency_p95_ms",
                                          "setup_s"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in \
        e2e["setup_s"]
    names = {m["name"] for m in M["end_to_end"] + M["per_layer"]}
    assert len(names) == len(M["end_to_end"]) + len(M["per_layer"])
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= cells and m["workloads"]
        # every cell that reads it reports the metric it moves
        assert set(m["workloads"]) <= reported_by(e2e[m["moves"]])
        assert (PB / "metrics" / f"{quantity(m['name'])}.py").is_file()
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for name in cells:
        assert any(name in m["workloads"] for m in M["per_layer"])
        # setup_s and at least one more
        assert sum(name in reported_by(m) for m in M["end_to_end"]) >= 2
    # a quantity reported once a cell, under one name
    for name in cells:
        mine = [quantity(m["name"]) for m in M["end_to_end"] + M["per_layer"]
                if name in reported_by(m)]
        assert len(mine) == len(set(mine))


@pytest.mark.parametrize("metric", ["kernels_roofline",
                                    "kernels_roofline.chains"])
def test_a_roofline_share_is_named_for_its_kernels(metric):
    m = {m["name"]: m for m in M["per_layer"]}[metric]
    assert m["unit"] == "%" and quantity(m["name"]).endswith("_roofline")
