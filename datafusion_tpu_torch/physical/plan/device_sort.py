"""Device lexicographic sort: a stable radix sort over encoded order words.

Counterpart of `datafusion_tpu/physical/plan/device_sort.py:54`
(`device_lexsort`, one stable multi-operand `lax.sort`). Sort keys are
encoded into monotonic words on the host first (`sort.py` `order_keys`: a
uint8 null rank and a uint64 value word per key, direction and NULL
placement already applied), so the kernel is type-agnostic. The returned
permutation equals `np.lexsort` over the reversed words, ties included.

`radix_sort` runs the hand-written kernel `csrc/radix_sort.cu` on CUDA
tensors (or raises) and its plain PyTorch version on CPU tensors: a chain
of stable `torch.sort` calls, least significant word first. Sizes are
exact, so there is no pad word and no capacity bucket. Whether a sort
runs here or in host numpy is `lexsort`'s choice (`sort.py`): the plan's
device and `datafusion.tpu.device_sort_min_rows`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ... import kernels

radix_sort_kernel = kernels.register(kernels.Kernel(
    "radix_sort", "datafusion_tpu_torch/csrc/radix_sort.cu",
    "datafusion_tpu/physical/plan/device_sort.py:54"))

DEFAULT_MIN_ROWS = 1 << 17
TILE = 4096              # rows a block of csrc/radix_sort.cu
SCAN_TILE = 8192         # words a block of csrc/scan.cuh
_WORD_DTYPES = (torch.uint8, torch.int64)   # int64 holds uint64 bits
_I64_MIN = np.iinfo(np.int64).min


def min_rows(config) -> int:
    """`datafusion.tpu.device_sort_min_rows` of a session's config."""
    if config is None:
        return DEFAULT_MIN_ROWS
    return int(config.get("datafusion.tpu.device_sort_min_rows"))


def _check_words(words: Sequence[torch.Tensor]) -> int:
    if not words:
        raise ValueError("a sort needs at least one word")
    n, dev = words[0].numel(), words[0].device
    for w in words:
        if w.dtype not in _WORD_DTYPES or w.dim() != 1 or \
                not w.is_contiguous() or w.numel() != n or w.device != dev:
            raise ValueError("order words must be contiguous uint8 or int64 "
                             "(uint64 bits) [n] tensors on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n


def radix_sort(words: Sequence[torch.Tensor],
               limit: Optional[int] = None) -> torch.Tensor:
    """The stable ascending permutation (int64) over `words`, most
    significant first, cut to `min(n, limit)` rows.

    On CPU tensors this runs `radix_sort_plain`; on CUDA tensors it
    launches the `radix_sort` kernels or raises. It reads each word's digit
    counts back to skip the bytes that do not vary: one synchronisation a
    word."""
    n = _check_words(words)
    if words[0].device.type == "cpu":
        return radix_sort_plain(words, limit)
    k = n if limit is None else min(n, limit)
    dev = words[0].device
    if n <= 1:
        return torch.arange(k, dtype=torch.int64, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        nb = -(-n // TILE)
        counts = torch.empty(256 * nb, dtype=torch.int64, device=dev)
        sums = torch.empty(max(-(-256 * nb // SCAN_TILE), 1),
                           dtype=torch.int64, device=dev)
        keys = [torch.empty(n, dtype=torch.int64, device=dev)
                for _ in range(2)]
        perms = [torch.empty(n, dtype=torch.int64, device=dev)
                 for _ in range(2)]
        perm = None              # None: the identity
        for w in reversed(words):
            width = w.element_size()
            hist = torch.zeros(width * 256, dtype=torch.int64, device=dev)
            kernels.check(lib.dft_radix_word_hist(
                w.data_ptr(), width, n, hist.data_ptr(), stream),
                radix_sort_kernel)
            radix_sort_kernel.launches += 1
            varying = [b for b, row in enumerate(hist.view(width, 256).cpu())
                       if int(row.max()) < n]
            if not varying:
                continue
            src = w
            if perm is not None:
                src = keys[0]
                kernels.check(lib.dft_radix_gather(
                    w.data_ptr(), width, perm.data_ptr(), n, src.data_ptr(),
                    stream), radix_sort_kernel)
                radix_sort_kernel.launches += 1
            for j, b in enumerate(varying):
                out_keys = None if j == len(varying) - 1 else \
                    (keys[1] if src is keys[0] else keys[0])
                out_perm = perms[1] if perm is perms[0] else perms[0]
                kernels.check(lib.dft_radix_pass(
                    src.data_ptr(), width,
                    None if perm is None else perm.data_ptr(), n, 8 * b,
                    counts.data_ptr(), sums.data_ptr(),
                    None if out_keys is None else out_keys.data_ptr(),
                    out_perm.data_ptr(), stream), radix_sort_kernel)
                radix_sort_kernel.launches += 5
                src, perm = out_keys, out_perm
        if perm is None:
            return torch.arange(k, dtype=torch.int64, device=dev)
    return perm[:k]


def radix_sort_plain(words: Sequence[torch.Tensor],
                     limit: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version: one stable `torch.sort` a word, least
    significant first, each word read through the permutation so far. A
    uint64 word sorts as int64 with its top bit flipped."""
    n = _check_words(words)
    perm = torch.arange(n, dtype=torch.int64, device=words[0].device)
    for w in reversed(words):
        key = w[perm]
        key = key.to(torch.int64) if key.dtype == torch.uint8 \
            else key ^ _I64_MIN
        perm = perm[torch.sort(key, stable=True).indices]
    return perm if limit is None else perm[:limit]


def to_word(w: np.ndarray) -> torch.Tensor:
    """A host order word (uint8 null rank, uint64 key, or bool) as a CPU
    tensor of `radix_sort`'s word types: uint64 as int64 bits."""
    w = np.ascontiguousarray(w)
    if w.dtype == np.uint64:
        w = w.view(np.int64)
    elif w.dtype == np.bool_:
        w = w.view(np.uint8)
    elif w.dtype != np.uint8:
        raise ValueError(f"order word of dtype {w.dtype}")
    return torch.from_numpy(w)


def device_lexsort(words: List[np.ndarray], n: int, limit: Optional[int],
                   device: torch.device) -> np.ndarray:
    """Stable ascending permutation over host order words (most
    significant first) on `device`: the permutation
    `np.lexsort(tuple(reversed(words)))` returns, cut to `min(n, limit)`
    rows."""
    with record_function("dft.sort.h2d"):
        staged = [to_word(w[:n]).to(device) for w in words]
    with record_function("dft.sort.radix"):
        perm = radix_sort(staged, limit)
    del staged
    with record_function("dft.sort.d2h"):
        return perm.cpu().numpy()
