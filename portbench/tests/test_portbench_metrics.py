"""Each per-layer metric's reader, the breakdown and the kernel check on a
synthetic trace."""
import importlib.util

import pytest

from portbench import trace as T
from portbench.tests.common import ROOT

PB = ROOT / "portbench"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, PB / "metrics" / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m.read


def synthetic():
    """Two chunks of two queries each: 1 s and 0.5 s of window."""
    return {
        "queries": 4, "window_s": 1.5,
        "chunks": [(0.0, 1.0), (10.0, 10.5)],
        "spans": [("pb.query", 0.0, 0.5), ("pb.query", 0.5, 1.0),
                  ("pb.query", 10.0, 10.2), ("pb.query", 10.2, 10.5),
                  ("dft.compile", 0.0, 0.2), ("dft.compile", 0.1, 0.3),
                  ("dft.build", 0.6, 0.7), ("pb.sql", 10.0, 10.3)],
        "device": [("void k_a<1>(int)", "kernel", 0.3, 0.4),
                   ("void k_b(int)", "kernel", 0.35, 0.45),
                   ("Memcpy HtoD (Pageable -> Device)", "memcpy", 0.8, 0.9),
                   ("void k_a<1>(int)", "kernel", 10.3, 10.4)],
        "frontend_s": [0.001, 0.002, 0.003, 0.002],
        "bytes_needed": 3.35e9, "peak_bytes_per_s": 3.35e12,
    }


def test_frontend_ms_is_the_mean_of_the_own_clock():
    assert reader("frontend_ms")(synthetic()) == pytest.approx(2.0)
    assert reader("frontend_ms")(dict(synthetic(), frontend_s=[])) is None


def test_key_pack_ms_is_the_union_of_nested_compile_spans():
    assert reader("key_pack_ms")(synthetic()) == pytest.approx(300 / 4)
    t = dict(synthetic(), spans=[s for s in synthetic()["spans"]
                                 if s[0] != "dft.compile"])
    assert reader("key_pack_ms")(t) is None


def test_chain_build_ms_reads_the_build_spans():
    assert reader("chain_build_ms")(synthetic()) == pytest.approx(100 / 4)
    t = dict(synthetic(), spans=[])
    assert reader("chain_build_ms")(t) is None


def test_kernels_roofline_divides_the_bytes_time_by_kernel_time():
    # 1 ms of bytes at the peak over 0.3 s of kernels (copies left out)
    assert reader("kernels_roofline")(synthetic()) == pytest.approx(
        100 * 1e-3 / 0.3)
    assert reader("kernels_roofline")(dict(synthetic(), device=[])) is None
    assert reader("kernels_roofline")(
        dict(synthetic(), peak_bytes_per_s=None)) is None


def test_device_idle_pct_takes_the_union_of_device_intervals():
    # busy: 0.3-0.45, 0.8-0.9, 10.3-10.4 = 0.35 s of 1.5 s
    assert reader("device_idle_pct")(synthetic()) == pytest.approx(
        100 * (1 - 0.35 / 1.5))
    assert reader("device_idle_pct")(dict(synthetic(), device=[])) is None


def test_breakdown_names_kernels_and_idle_gaps_by_host_span():
    b = T.breakdown(synthetic())
    ops = dict(b["device_ops"])
    assert ops["k_a<1>"] == pytest.approx(0.2)
    assert ops["k_b"] == pytest.approx(0.1)
    gaps = dict(b["idle_gaps"])
    assert gaps["dft.compile"] == pytest.approx(0.3)
    assert gaps["dft.build"] == pytest.approx(0.35)
    assert gaps["pb.sql"] == pytest.approx(0.3)
    assert gaps["harness"] == pytest.approx(0.2)
    assert sum(gaps.values()) == pytest.approx(1.5 - 0.35)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_kernel_names_of_the_program_sources():
    from portbench import program
    names = T.kernel_names(program.csrc())
    for k in ("fused_dense_aggregate_kernel", "chain_hash_kernel",
              "chain_build_insert_kernel", "scan_tile_sums",
              "compact_copy_kernel"):
        assert k in names
    assert "__launch_bounds__" not in names


class FakeProfile:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {})()
        self.profiler.kineto_results.events = lambda: events


class FakeEvent:
    def __init__(self, name, cuda, start, end):
        import torch
        self._n, self._s, self._e = name, start, end
        self._d = torch.autograd.DeviceType.CUDA if cuda else \
            torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_a_chunk_missing_kernel_events_is_left_out():
    # cycles of one warm-up step and 2 recorded steps: steps 1-2, then 4
    tr = T.Tracer(2, ["k_a"], launches=lambda: 0)
    tr.totals = [0, 0, 1, 2, 2, 3]
    tr._ready(FakeProfile([
        FakeEvent("pb.query", False, 0, 10), FakeEvent("pb.query", False,
                                                       10, 20),
        FakeEvent("void k_a(int)", True, 2, 3),
        FakeEvent("void k_a(int)", True, 12, 13)]))
    tr._ready(FakeProfile([FakeEvent("pb.query", False, 30, 40),
                           FakeEvent("void at::fill(int)", True, 31, 32)]))
    out = tr.result()
    assert out["dropped"] == [(1, 1, 0, [4])]
    assert out["queries"] == 2 and out["steps"] == [1, 2]
    assert out["window_s"] == pytest.approx(20e-9)
    assert [d[1] for d in out["device"]] == ["kernel"] * 2


def test_short_names_of_kernels():
    assert T.short_name("void (anonymous namespace)::k<(Mode)1>(In)") == \
        "k<(Mode)1>"
    assert T.short_name("void at::native::f<2, at::native::F<long> >("
                        "int, F)") == "at::native::f<2, at::native::F<long> >"
    assert T.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD "


def test_a_few_chunks_may_be_left_out_and_are_named_by_template():
    from portbench import harness
    answers = [("q1", []), ("q6", [])] * 30
    # 40 queries kept, 2 left out (5%): kept; 3 left out: the run fails
    kept = {"chunks": [(0.0, 1.0)], "steps": list(range(40)),
            "dropped": [(20, 3, 2, [40, 41])]}
    assert harness.dropped_queries(kept, answers) == {"q1": 1, "q6": 1}
    assert harness.dropped_queries(dict(kept, dropped=[]), answers) == {}
    more = dict(kept, dropped=[(20, 3, 2, [40, 41]), (21, 3, 1, [42])])
    with pytest.raises(RuntimeError, match="holding 3 of 43"):
        harness.dropped_queries(more, answers)
    with pytest.raises(RuntimeError):
        harness.dropped_queries(dict(kept, chunks=[], steps=[]), answers)


def test_a_traced_chunk_holds_whole_rounds():
    import json
    from portbench import harness
    for path in sorted((PB / "workloads").glob("*.json")):
        w = json.loads(path.read_text())
        assert w["trace_chunk"] % len(w["queries"]) == 0, path.name
        assert harness.Cell(path.stem).workload == w
