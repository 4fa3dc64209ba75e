"""Native host kernels (C extension), built lazily.

The extension accelerates per-dictionary-entry string loops (value
hashing for join/shuffle placement, LIKE matching). Everything degrades
gracefully to the pure-Python implementations when a C compiler is
unavailable.
"""
from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_mod = None
_tried = False


def _build() -> Optional[object]:
    # Always compiled from the checked-in C source into the package's own
    # (gitignored) build directory, apart from the JAX package's cache, so
    # the two packages never load one shared object in one process; the
    # loaded code always corresponds to fastkernels.c.
    src = os.path.join(_HERE, "fastkernels.c")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    cache_dir = os.path.join(os.path.dirname(_HERE), "_build", "native")
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, f"fastkernels{suffix}")
    if not os.path.exists(out) or \
            os.path.getmtime(out) < os.path.getmtime(src):
        cc = os.environ.get("CC", "gcc")
        include = sysconfig.get_paths()["include"]
        cmd = [cc, "-O3", "-shared", "-fPIC", f"-I{include}", src, "-o", out]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception:  # noqa: BLE001 — no compiler: fall back to Python
            return None
    try:
        import importlib.util
        spec = importlib.util.spec_from_file_location("fastkernels", out)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except Exception:  # noqa: BLE001
        return None


def get() -> Optional[object]:
    global _mod, _tried
    if not _tried:
        _tried = True
        _mod = _build()
    return _mod


def fnv1a64_bulk(values) -> Optional[np.ndarray]:
    """uint64 FNV-1a per string, or None when the extension is missing."""
    mod = get()
    if mod is None:
        return None
    raw = mod.fnv1a64_bulk(list(values))
    return np.frombuffer(raw, dtype=np.uint64).copy()


def like_bulk(values, pattern: str, case_insensitive: bool = False
              ) -> Optional[np.ndarray]:
    mod = get()
    if mod is None:
        return None
    # The C matcher is byte-oriented: '_' consumes one byte and
    # case-folding is ASCII-only. Route non-ASCII patterns/values to the
    # per-character regex fallback (arrow semantics are per-character).
    vals = list(values)
    if not pattern.isascii() or not all(
            isinstance(v, str) and v.isascii() for v in vals):
        return None
    raw = mod.like_bulk(vals, pattern.encode(),
                        1 if case_insensitive else 0)
    return np.frombuffer(raw, dtype=np.uint8).astype(bool)
