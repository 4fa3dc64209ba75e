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

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ... import kernels

radix_sort_kernel = kernels.register(kernels.Kernel(
    "radix_sort", "datafusion_tpu_torch/csrc/radix_sort.cu",
    "datafusion_tpu/physical/plan/device_sort.py:54"))

DEFAULT_MIN_ROWS = 1 << 17
TILE = 4096              # rows a tile of csrc/radix_sort.cu's byte pass
DIGITS = 256
MAX_ROWS = 1 << 40       # the count field of a status word (radix_sort.cu)
_WORD_DTYPES = (torch.uint8, torch.int64)   # int64 holds uint64 bits
_I64_MIN = np.iinfo(np.int64).min


class BytePass(NamedTuple):
    """One launch of the radix sort's byte pass: digit `byte` of word
    `word` (an index into the words, most significant first)."""
    word: int
    byte: int
    gather: bool      # the word's first pass after an earlier word's: its
    #                   keys are read through the permutation first
    keys_out: bool    # a later pass of the same word reads the keys


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


def byte_passes(hists: Sequence[np.ndarray], n: int) -> List[BytePass]:
    """The byte passes of a sort of n rows, in launch order (least
    significant word first, low byte first), from each word's digit counts
    (`hists[w]`: [width, 256], the word's `word_hist`): a byte whose rows
    all share one digit is skipped, and a word all of whose bytes are is
    skipped whole."""
    passes: List[BytePass] = []
    for w in reversed(range(len(hists))):
        varying = [b for b, row in enumerate(hists[w]) if int(row.max()) < n]
        for j, b in enumerate(varying):
            passes.append(BytePass(w, b, gather=j == 0 and bool(passes),
                                   keys_out=j < len(varying) - 1))
    return passes


def digit_counts(w: np.ndarray) -> np.ndarray:
    """The digit counts of every byte of a host order word ([width, 256]),
    as `dft_radix_word_hist` counts them on the card."""
    w = np.asarray(w)
    u = w.astype(np.uint64)
    return np.stack([np.bincount(((u >> np.uint64(8 * b)) & np.uint64(255))
                                 .astype(np.int64), minlength=DIGITS)
                     for b in range(w.itemsize)])


def sort_launch_count(words: Sequence[np.ndarray]) -> int:
    """`radix_sort`'s launches over host order words (as `to_word` takes
    them): none for one row or fewer, else a digit histogram a word, one
    launch a byte pass (`byte_passes`) and a gather before each later
    word's first pass."""
    n = len(words[0])
    if n <= 1:
        return 0
    passes = byte_passes([digit_counts(w) for w in words], n)
    return len(words) + len(passes) + sum(p.gather for p in passes)


def status_words(n: int) -> int:
    """uint64 words of the status array that every byte pass of a sort of
    n rows shares: one a (tile, digit)."""
    return -(-n // TILE) * DIGITS


def radix_sort(words: Sequence[torch.Tensor],
               limit: Optional[int] = None) -> torch.Tensor:
    """The stable ascending permutation (int64) over `words`, most
    significant first, cut to `min(n, limit)` rows.

    On CPU tensors this runs `radix_sort_plain`; on CUDA tensors it
    launches the `radix_sort` kernels or raises: every word's digit
    counts, read back at once (the sort's one synchronisation) to skip
    the bytes that do not vary, then one launch a byte pass and one gather
    a later word."""
    n = _check_words(words)
    if words[0].device.type == "cpu":
        return radix_sort_plain(words, limit)
    k = n if limit is None else min(n, limit)
    dev = words[0].device
    if n <= 1:
        return torch.arange(k, dtype=torch.int64, device=dev)
    if n >= MAX_ROWS:
        raise ValueError(f"radix_sort takes fewer than {MAX_ROWS} rows")
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        widths = [w.element_size() for w in words]
        at = np.cumsum([0] + [DIGITS * x for x in widths])
        hist = torch.zeros(int(at[-1]), dtype=torch.int64, device=dev)
        for w, x, off in zip(words, widths, at):
            kernels.check(lib.dft_radix_word_hist(
                w.data_ptr(), x, n, hist[int(off):].data_ptr(), stream),
                radix_sort_kernel)
        radix_sort_kernel.launches += len(words)
        host = hist.cpu().numpy()
        passes = byte_passes([host[a:b].reshape(-1, DIGITS)
                              for a, b in zip(at[:-1], at[1:])], n)
        if not passes:
            return torch.arange(k, dtype=torch.int64, device=dev)
        # the tile counters of every pass, then the status words
        scratch = torch.zeros(len(passes) + status_words(n),
                              dtype=torch.int64, device=dev)
        status = scratch[len(passes):]
        keys = [torch.empty(n, dtype=torch.int64, device=dev)
                for _ in range(2)]
        perms = [torch.empty(n, dtype=torch.int64, device=dev)
                 for _ in range(2)]
        src, perm = None, None    # perm None: the identity
        for e, p in enumerate(passes):
            word, width = words[p.word], widths[p.word]
            if p.gather:
                kernels.check(lib.dft_radix_gather(
                    word.data_ptr(), width, perm.data_ptr(), n,
                    keys[0].data_ptr(), stream), radix_sort_kernel)
                radix_sort_kernel.launches += 1
                src = keys[0]
            elif e == 0:
                src = word
            out_keys = (keys[1] if src is keys[0] else keys[0]) \
                if p.keys_out else None
            out_perm = perms[1] if perm is perms[0] else perms[0]
            kernels.check(lib.dft_radix_pass(
                src.data_ptr(), width,
                None if perm is None else perm.data_ptr(), n, 8 * p.byte,
                hist[int(at[p.word]) + DIGITS * p.byte:].data_ptr(),
                status.data_ptr(), e + 1, scratch[e:].data_ptr(),
                None if out_keys is None else out_keys.data_ptr(),
                out_perm.data_ptr(), stream), radix_sort_kernel)
            radix_sort_kernel.launches += 1
            src, perm = out_keys, out_perm
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
