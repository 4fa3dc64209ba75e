"""`csrc/window_scan.cu` compiled for the CPU, against `window_scan_plain`.

`g++` builds the kernel bodies of `window_scan.cu` (above its `extern "C"`
launch wrapper) with `lookback.cuh` through `test_torch_csrc_cpu.py`'s
`SHIM`, where a block is one thread: a tile is then 8 rows, so partitions,
peer groups, frames and a lead's source rows cross tiles at every size.
The tiles run one after another, in the order the tile counter hands
them out, so each tile's look-back finds the tile before it inclusive and
takes its carry, and a frame's halo is the last rows the tile before
published (past 8 rows, what that tile took from its own predecessor).
The port's own `window_scan` wrapper runs its CUDA path on CPU tensors
into this build (its device test made true and the kernel library faked),
so the plan (`_pass_plan`), the scratch and the launch count are the
wrapper's own. Every function kind and frame bound must equal
`window_scan_plain` bit for bit, float sums included (one thread adds the
prefix sums in `torch.cumsum`'s order, with -0.0 values in the lane), at
n = 1, 9, 1001 and 2049 (just above multiples of the tile), with
partitions of one row each, one partition of the whole input, and runs of
up to 40 rows.
"""
import contextlib
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from datafusion_tpu_torch import kernels
from datafusion_tpu_torch.device import groupby as gb
from datafusion_tpu_torch.device.window import (
    HALO, scan_launches, window_scan, window_scan_plain)

HARNESS = r"""
#include <stdint.h>
#include <type_traits>
#include "lookback.cuh"
namespace ws { namespace { long long smem[1 << 16]; }
#include "window_scan_k.cu"
}
extern "C" int h_window(const void* const* words, const int* widths,
                        int n_words, int n_part, long long n,
                        const long long* spec, int fields, int halo,
                        int arrays, const void* perm, const void* val,
                        const void* valid, const void* dflt,
                        const void* dvalid, int width, void* out0,
                        void* out1, void* const* eval, void* state,
                        void* records, void* halo_out, long long tiles) {
  void* none[6] = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  ws::PassIn in;
  if (!ws::pass_in(&in, words, widths, n_words, n_part, n, spec, halo,
                   arrays, perm, val, valid, dflt, dvalid, width, out0,
                   out1, arrays ? eval : none, state, records, halo_out,
                   tiles)) {
    return 1;
  }
  const bool ok = ws::with_fields(fields, [&](auto f) {
    for (long long t = 0; t < tiles; ++t) {
      ws::window_pass_kernel<decltype(f)::value>(in);
    }
  });
  if (!ok) return 2;
  if (arrays) ws::eval_kernel(ws::eval_in(in));
  return 0;
}
"""
# a block of one thread takes kPer rows
SHIM_TILE = 8


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    from test_torch_csrc_cpu import CSRC, SHIM
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    d = tmp_path_factory.mktemp("window_cpu")
    (d / "cuda_runtime.h").write_text(SHIM + "#define __grid_constant__\n")
    (d / "harness.cpp").write_text(HARNESS)
    shutil.copy(os.path.join(CSRC, "lookback.cuh"), d / "lookback.cuh")
    (d / "scan.cuh").write_text("#pragma once\n")
    with open(os.path.join(CSRC, "window_scan.cu")) as f:
        src = f.read()
    (d / "window_scan_k.cu").write_text(src[:src.index('extern "C"')])
    so = d / "libwindow_cpu.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(d), "-w", "-o", str(so), str(d / "harness.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.h_window.argtypes = [P, P, I, I, LL, P, I, I, I, P, P, P, P, P, I, P,
                             P, P, P, P, P, LL]
    return lib


class _ShimLibrary:
    """The kernel library as `window_scan` calls it, run by the CPU build:
    the wrapper's tile count is of 2,048-row tiles, the build's of 8."""

    def __init__(self, lib):
        self.lib = lib

    def dft_window_pass(self, words, widths, n_words, n_part, n, spec,
                        fields, halo, arrays, perm, val, valid, dflt, dvalid,
                        width, out0, out1, evals, state, records, halo_out,
                        _tiles, _stream):
        tiles = -(-n // SHIM_TILE)
        scratch = [torch.zeros(tiles + 1, dtype=torch.int64),
                   torch.empty(2 * tiles * 7, dtype=torch.int64),
                   torch.empty(max(tiles * 2 * halo, 1), dtype=torch.int64)]
        return self.lib.h_window(
            words, widths, n_words, n_part, n, spec, fields, halo, arrays,
            perm, val, valid, dflt, dvalid, width, out0, out1, evals,
            scratch[0].data_ptr(), scratch[1].data_ptr(),
            scratch[2].data_ptr() if halo_out else None, tiles)


@pytest.fixture()
def card(shim, monkeypatch):
    monkeypatch.setattr(gb, "_cuda", lambda t: True)
    monkeypatch.setattr(gb, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "library", lambda: _ShimLibrary(shim))


SPECS = [("rank", f) for f in ("row_number", "rank", "dense_rank",
                               "percent_rank", "cume_dist")] + [
    ("ntile", 3), ("ntile", 40),
    ("shift", -1), ("shift", -13), ("shift", 0), ("shift", 1),
    ("shift", 11), ("shift", HALO), ("shift", HALO + 5),
    ("agg", "sum_f", "part", 0, "part", 0),
    ("agg", "sum_f", "part", 0, "cur", 0),
    ("agg", "sum_f", "rows", -6, "cur", 0),
    ("agg", "sum_f", "rows", -20, "rows", -3),
    ("agg", "sum_f", "cur", 0, "cur", 0),
    ("agg", "sum_f", "peer", 0, "peer", 0),
    ("agg", "sum_i", "part", 0, "cur", 0),
    ("agg", "sum_i", "rows", -6, "cur", 0),
    ("agg", "sum_i", "rows", 2, "rows", -1),
    ("agg", "sum_i", "rows", -HALO + 1, "cur", 0),
    ("agg", "sum_i", "rows", -HALO, "cur", 0),
    ("agg", "sum_i", "part", 0, "peer", 0),
    ("agg", "sum_i", "cur", 0, "part", 0),
    ("agg", "sum_i", "rows", -2, "rows", 3),
    ("agg", "cnt", "rows", -9, "rows", -1),
    ("agg", "cnt", "part", 0, "rows", 0),
    ("agg", "cnt", "peer", 0, "rows", 2),
]


def _words(n, layout, rng):
    """Two partition words (uint8, int64) and two order words (uint8,
    int64), as sorted rows: partitions of one row each, one partition, or
    runs of 1 to 40 rows; peer groups of 1 to 5 rows inside them."""
    if layout == "single":
        part = np.arange(n)
    elif layout == "whole":
        part = np.zeros(n, np.int64)
    else:
        part = np.repeat(np.arange(n), rng.integers(1, 41, n))[:n]
    peer = np.repeat(np.arange(n), rng.integers(1, 6, n))[:n]
    words = [(part % 3).astype(np.uint8), part // 3,
             (peer % 2).astype(np.uint8), peer * 7]
    return [torch.from_numpy(np.ascontiguousarray(w)) for w in words]


def _lanes(spec, n, rng):
    """(arg, arg_valid, default, default_valid) for `spec`, in sorted
    order."""
    kind = spec[0]
    valid = torch.from_numpy(rng.random(n) > 0.2)
    if kind == "shift":
        arg = torch.from_numpy(rng.integers(-100, 100, n).astype(np.int32))
        dflt = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
        return arg, valid, dflt, torch.from_numpy(rng.random(n) > 0.5)
    if kind != "agg":
        return None, None, None, None
    if spec[1] == "cnt":
        return None, valid, None, None
    if spec[1] == "sum_i":
        arg = rng.integers(-2 ** 62, 2 ** 62, n)      # sums wrap
    else:
        arg = rng.normal(size=n) * 1e3
        arg[rng.random(n) < 0.1] = -0.0
    return torch.from_numpy(arg), valid, None, None


@pytest.mark.parametrize("layout", ["runs", "single", "whole"])
@pytest.mark.parametrize("n", [1, 9, 1001, 2049])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_window_pass_matches_plain(card, spec, n, layout):
    rng = np.random.default_rng(n * 7 + len(layout))
    words = _words(n, layout, rng)
    perm = torch.from_numpy(rng.permutation(n))
    lanes = _lanes(spec, n, rng)
    k = kernels.KERNELS["window_scan"]
    before = k.launches
    got = window_scan(words, 2, perm, spec, *lanes)
    assert k.launches - before == scan_launches(spec)
    want = window_scan_plain(words, 2, perm, spec, *lanes)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype, key
        if w.dtype == torch.float64:     # bit for bit: -0.0, NaN
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w), key


@pytest.mark.parametrize("spec", [("rank", "rank"), ("shift", 3),
                                  ("agg", "sum_f", "rows", -6, "cur", 0),
                                  ("agg", "sum_i", "part", 0, "part", 0)],
                         ids=str)
def test_window_pass_without_a_default_or_validity(card, spec):
    """A shift with no default lane and lanes with no validity (all valid),
    which the wrapper passes as null."""
    n = 300
    rng = np.random.default_rng(3)
    words = _words(n, "runs", rng)
    perm = torch.from_numpy(rng.permutation(n))
    arg = None
    if spec[0] == "shift":
        arg = torch.from_numpy(rng.integers(0, 50, n))
    elif spec[0] == "agg":
        arg = torch.from_numpy(rng.normal(size=n) if spec[1] == "sum_f"
                               else rng.integers(-50, 50, n))
    got = window_scan(words, 2, perm, spec, arg)
    want = window_scan_plain(words, 2, perm, spec, arg)
    for key, w in want.items():
        g = got[key]
        if w.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w), key


def test_one_pass_plan():
    """The functions that need no segment end take one launch; the halo is
    what a frame reads behind its tile or a lead past it."""
    assert [scan_launches(s) for s in (
        ("rank", "row_number"), ("rank", "rank"), ("rank", "dense_rank"),
        ("shift", -1), ("shift", HALO), ("agg", "sum_i", "rows", -6, "cur", 0),
        ("agg", "cnt", "part", 0, "cur", 0))] == [1] * 7
    assert [scan_launches(s) for s in (
        ("rank", "percent_rank"), ("rank", "cume_dist"), ("ntile", 4),
        ("shift", HALO + 1), ("agg", "sum_i", "part", 0, "part", 0),
        ("agg", "sum_f", "part", 0, "peer", 0),
        ("agg", "sum_i", "rows", -HALO, "cur", 0))] == [2] * 7
