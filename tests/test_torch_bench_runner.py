"""The port's benchmark runner (`python -m datafusion_tpu_torch.bench_runner`)
on the CPU: each suite prints its per-query lines and one JSON line, the
tpch suite's with `q1`-`q22`, with the device aggregate on and off
(`--no-device`); and it takes the card unless it is given the CPU."""
import json

import pytest
import torch

import datafusion_tpu_torch as dft
from datafusion_tpu_torch import bench_runner
from datafusion_tpu_torch.physical.plan.device_aggregate import (
    TorchDeviceExec)


@pytest.fixture()
def sessions(monkeypatch):
    """Every SessionContext the runner opens, in order."""
    made = []

    class Recorded(dft.SessionContext):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(dft, "SessionContext", Recorded)
    return made


def _summary(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])


def _device_execs(ctx, sql):
    def walk(node):
        yield node
        for c in node.children():
            yield from walk(c)
    return [n for n in walk(ctx.sql(sql).create_physical_plan())
            if isinstance(n, TorchDeviceExec)]


@pytest.mark.parametrize("no_device", [False, True])
def test_tpch_suite(sessions, capsys, no_device):
    argv = ["tpch", "--sf", "0.01", "--iterations", "1", "--device", "cpu"]
    assert bench_runner.main(argv + ["--no-device"] * no_device) == 0
    lines, out = _summary(capsys)
    assert out["suite"] == "tpch"
    assert list(out["ms"]) == [f"q{n}" for n in range(1, 23)]
    assert all(v >= 0 for v in out["ms"].values())
    assert sum(line.startswith("Q") for line in lines) == 22
    (ctx,) = sessions
    assert ctx.device == torch.device("cpu")
    from datafusion_tpu_torch.tpch import QUERIES
    assert bool(_device_execs(ctx, QUERIES[1])) is not no_device


@pytest.mark.parametrize("suite,keys", [
    ("clickbench", [f"cb{n}" for n in range(1, 44)]),
    ("h2o", [f"h2o_q{n}" for n in range(1, 10)]),
])
def test_clickbench_and_h2o_suites(sessions, capsys, suite, keys):
    argv = [suite, "--rows", "3000", "--iterations", "1", "--device", "cpu"]
    assert bench_runner.main(argv) == 0
    _lines, out = _summary(capsys)
    assert out["suite"] == suite and list(out["ms"]) == keys
    assert [c.device for c in sessions] == [torch.device("cpu")]


def test_runner_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runner uses it")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        bench_runner.main(["h2o", "--rows", "100", "--iterations", "1"])
