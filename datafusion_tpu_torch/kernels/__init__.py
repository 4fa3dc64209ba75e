"""Build and load the port's hand-written CUDA kernels.

At first use every `csrc/*.cu` source is compiled with `nvcc` for Hopper
(`sm_90a`), one `nvcc` process per source, all started together, and the
objects are linked into one shared library with a plain C interface,
`_build/libdftorch.so`, loaded with `ctypes`. The library is rebuilt when
the hash of the sources, the shared headers (`csrc/*.cuh`) or the flags
changes. There is no fallback: if
`nvcc` is missing or the build fails, `library()` raises, and a wrapper
given a CUDA tensor either launches its kernel or raises.

Each kernel is described by a `Kernel`, which counts its launches so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
LIB = BUILD / "libdftorch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# C entry points: name -> argtypes; each returns cudaGetLastError()
_SIGNATURES = {
    "dft_fused_dense_aggregate": [_P, _I, _I, _I, _P, _LL, _P, _I, _P],
    "dft_hash_group_aggregate": [_P, _I, _I, _I, _P, _LL, _LL, _I, _P, _P, _I,
                                 _P],
    "dft_compact_mark": [_P, _I, _I, _P, _LL, _P, _LL, _P, _P, _P],
    "dft_compact_copy": [_P, _LL, _I, _P, _LL, _P, _P, _P, _LL, _P],
    "dft_group_topk": [_P, _LL, _I, _I, _LL, _P, _P, _LL, _P, _P, _P,
                       _P],
    "dft_chain_build_range": [_P, _I, _P, _LL, _P, _I, _P],
    "dft_chain_build_insert": [_P, _I, _P, _LL, _I, _LL, _P, _P, _P, _P, _P,
                               _I, _P],
    "dft_chain_aggregate": [_P, _I, _I, _I, _P, _LL, _LL, _I, _P, _P, _I,
                            _I, _I, _P],
    "dft_chain_rows_walk": [_P, _I, _P, _LL, _I, _I, _P, _P, _P, _I, _P],
    "dft_chain_rows_emit": [_P, _I, _P, _LL, _P, _P, _LL, _P, _I, _I, _P],
    "dft_chain_compose": [_P, _I, _P, _LL, _I, _P],
    "dft_chain_fold": [_P, _LL, _P],
    "dft_group_emit": [_P, _LL, _I, _P, _P],
    "dft_join_build_hash": [_P, _I, _P, _LL, _P, _P, _P, _I, _P],
    "dft_join_build_offsets": [_P, _LL, _LL, _P, _P, _P],
    "dft_join_build_scatter": [_P, _P, _I, _LL, _LL, _P, _P, _P, _I, _I, _P,
                               _P, _P, _P],
    "dft_join_aggregate": [_P, _I, _I, _I, _P, _LL, _LL, _I, _P, _P, _I, _P],
    "dft_radix_word_hist": [_P, _I, _LL, _P, _P],
    "dft_radix_gather": [_P, _I, _P, _LL, _P, _P],
    "dft_radix_pass": [_P, _I, _P, _LL, _I, _P, _P, _LL, _P, _P, _P, _P],
    "dft_gather_pack": [_LL, _I, _P, _P, _P, _I, _P, _P],
    "dft_gather_records": [_P, _LL, _P, _I, _I, _P, _P, _P, _P],
    "dft_gather_direct": [_P, _LL, _I, _P, _P, _P, _P, _P],
    "dft_window_pass": [_P, _P, _I, _I, _LL, _P, _I, _I, _I, _P, _P, _P, _P,
                        _P, _I, _P, _P, _P, _P, _P, _P, _LL, _P],
    "dft_partition_count": [_P, _P, _LL, _I, _I, _I, _LL, _P, _P],
    "dft_partition_sweep": [_P, _P, _LL, _I, _I, _I, _LL, _P, _LL, _I, _P,
                            _P, _P, _P, _P, _P, _P],
    "dft_merge_partials": [_P, _LL, _I, _P, _I, _I, _P, _LL, _P, _LL, _P,
                           _P],
}


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times it was launched."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source      # path in the repository
        self.replaces = replaces  # file:line of the JAX program it ports
        self.launches = 0


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # of the last build in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def _inputs(csrc: Path):
    """The sources to compile, and the digest of every file the build reads
    (the sources and the shared headers) and of the flags."""
    sources = sorted(csrc.glob("*.cu"))
    return sources, _digest(sources + sorted(csrc.glob("*.cuh")))


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the output of any that fail."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n-> {proc.returncode}\n{out}")
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))


def _build(sources, digest: str) -> None:
    global build_seconds
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [BUILD / f"{s.stem}.{tag}.o" for s in sources]
    tmp = BUILD / f"libdftorch.{tag}.so"
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(sources, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, LIB)
    (BUILD / "libdftorch.sha256").write_text(digest)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources, digest = _inputs(CSRC)
        stamp = BUILD / "libdftorch.sha256"
        if not (LIB.exists() and stamp.exists()
                and stamp.read_text() == digest):
            _build(sources, digest)
        lib = ctypes.CDLL(str(LIB))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, kernel: Kernel) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise KernelLaunchError(f"{kernel.name}: CUDA error {rc}")
