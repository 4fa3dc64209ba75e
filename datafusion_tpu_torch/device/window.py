"""Window evaluation on the device: sort, gather, segment scans, scatter.

Counterpart of the JAX package's fused window program
(`datafusion_tpu/device/window.py:54` `device_window_eval`, `:122`
`_build_step`), with the same static spec tuples:

    ("rank", fn)        fn in row_number, rank, dense_rank, percent_rank,
                        cume_dist
    ("ntile", k)
    ("shift", offset)   lag (-offset) / lead (+offset), optional default
    ("agg", agg_kind, lo_kind, lo_off, hi_kind, hi_off)
        agg_kind in sum_f (float64 sum), sum_i (int64 sum), cnt; bound
        kinds "part" (partition edge), "cur" (current row), "peer" (peer
        group edge), "rows" (current row + offset)

One evaluation is three kernels: `radix_sort` (csrc/radix_sort.cu) over
the partition words then the order words, `reorder_rows`
(csrc/gather_lanes.cu) carrying the words and the value, validity and
default lanes into sorted order, and `window_scan` (csrc/window_scan.cu):
one forward pass that finds the partition and peer starts, scans the
fields the function reads across tiles by decoupled look-back, and writes
each result back to its row's original position (the JAX program sorts a
second time instead); a function that needs a segment's end
(`_pass_plan`) takes a second launch. Sizes are exact: there are no
padding rows to mask.

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its kernels on CUDA tensors, or raises. `window_scan_plain` transcribes
`_build_step` line by line, without the padding.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import kernels
from ..physical.plan.device_sort import radix_sort, to_word
from . import groupby
from .groupby import reorder_rows

window_scan_kernel = kernels.register(kernels.Kernel(
    "window_scan", "datafusion_tpu_torch/csrc/window_scan.cu",
    "datafusion_tpu/device/window.py:122"))

DEFAULT_MIN_ROWS = 1 << 17
TILE = 2048              # rows a block of csrc/window_scan.cu's pass takes
HALO = 64                # rows a tile reads past its edges
RECORD = 7               # int64 words of a tile's look-back record
MAX_WORDS = 32

# spec codes (mirrored in csrc/window_scan.cu)
_RANKS = {"row_number": 0, "rank": 1, "dense_rank": 2, "percent_rank": 3,
          "cume_dist": 4}
K_NTILE, K_SHIFT, K_AGG = 5, 6, 7
_AGGS = {"sum_i": 0, "sum_f": 1, "cnt": 2}
_BOUNDS = {"part": 0, "cur": 1, "peer": 2, "rows": 3}
# the fields the pass carries (csrc/window_scan.cu F_*)
F_QS, F_DENSE, F_SUM_I, F_SUM_F, F_CNT = 1, 2, 4, 8, 16
_RAW = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def min_rows(config) -> int:
    """`datafusion.tpu.device_window_min_rows` of a session's config."""
    if config is None:
        return DEFAULT_MIN_ROWS
    return int(config.get("datafusion.tpu.device_window_min_rows"))


def _spec_words(spec: Tuple) -> np.ndarray:
    """The kernel's seven spec words: kind, argument, aggregate, low bound
    kind and offset, high bound kind and offset."""
    kind = spec[0]
    if kind == "rank":
        words = [_RANKS[spec[1]], 0, 0]
    elif kind == "ntile":
        words = [K_NTILE, int(spec[1]), 0]
    elif kind == "shift":
        words = [K_SHIFT, int(spec[1]), 0]
    elif kind == "agg":
        _, agg, lo_kind, lo_off, hi_kind, hi_off = spec
        return np.array([K_AGG, 0, _AGGS[agg], _BOUNDS[lo_kind], int(lo_off),
                         _BOUNDS[hi_kind], int(hi_off)], np.int64)
    else:
        raise ValueError(f"window spec {spec!r}")
    return np.array(words + [0, 0, 0, 0], np.int64)


def _pass_plan(spec: Tuple) -> Tuple[int, bool, int]:
    """(the fields the pass carries, whether the function needs a segment's
    end and so the second launch, the rows a one-pass frame reads behind
    its tile or a lead past it). One pass: row_number, rank, dense_rank,
    lag, a lead of at most HALO rows, and a frame whose upper bound is the
    current row or behind it, whose lower bound is the partition start,
    the current row or a ROWS offset, within HALO rows."""
    kind = spec[0]
    if kind == "rank":
        return {"row_number": (0, False, 0), "rank": (F_QS, False, 0),
                "dense_rank": (F_DENSE, False, 0)}.get(spec[1],
                                                        (F_QS, True, 0))
    if kind == "ntile":
        return 0, True, 0
    if kind == "shift":
        off = int(spec[1])
        return (0, True, 0) if off > HALO else (0, False, max(off, 0))
    _, agg, lo_kind, lo_off, hi_kind, hi_off = spec
    fields = F_CNT | {"sum_i": F_SUM_I, "sum_f": F_SUM_F, "cnt": 0}[agg]
    if "peer" in (lo_kind, hi_kind):
        return fields | F_QS, True, 0
    halo = max(1, 1 - int(lo_off) if lo_kind == "rows" else 1,
               -int(hi_off) if hi_kind == "rows" else 0)
    behind = hi_kind == "cur" or (hi_kind == "rows" and int(hi_off) <= 0)
    if not behind or halo > HALO:
        return fields, True, 0
    return fields, False, halo


def scan_launches(spec: Tuple) -> int:
    """`window_scan`'s launches for one evaluation of `spec`: the pass, and
    the second launch where the function needs a segment's end."""
    return 1 + _pass_plan(spec)[1]


def _check(words: Sequence[torch.Tensor], n_part: int, perm: torch.Tensor,
           spec: Tuple, lanes: Sequence[Optional[torch.Tensor]]) -> None:
    n, dev = perm.numel(), perm.device
    if perm.dtype != torch.int64 or perm.dim() != 1 or \
            not perm.is_contiguous():
        raise ValueError("perm must be a contiguous int64 [n] tensor")
    if not 0 <= n_part <= len(words) <= MAX_WORDS:
        raise ValueError(f"{len(words)} words, {n_part} of them partition "
                         f"words: at most {MAX_WORDS}")
    for t in list(words) + [x for x in lanes if x is not None]:
        if t.numel() != n or t.dim() != 1 or not t.is_contiguous() or \
                t.device != dev:
            raise ValueError("words and lanes must be contiguous [n] "
                             "tensors on the permutation's device")
    for w in words:
        if w.dtype not in (torch.uint8, torch.int64):
            raise ValueError("order words must be uint8 or int64 tensors")
    arg, arg_valid, default, default_valid = lanes
    for v in (arg_valid, default_valid):
        if v is not None and v.dtype != torch.bool:
            raise ValueError("validity lanes must be bool")
    kind = spec[0]
    needs_arg = kind == "shift" or (kind == "agg" and spec[1] != "cnt")
    if needs_arg and arg is None:
        raise ValueError(f"{spec!r} needs a value lane")
    if kind == "agg" and spec[1] == "cnt" and arg is not None:
        raise ValueError("a count reads only the validity lane")
    if kind == "agg" and spec[1] != "cnt":
        want = torch.float64 if spec[1] == "sum_f" else torch.int64
        if arg.dtype != want:
            raise ValueError(f"{spec[1]} sums a {want} lane, not {arg.dtype}")
    if default is not None and (kind != "shift" or default.dtype != arg.dtype):
        raise ValueError("a default lane belongs to a shift, in its dtype")


def window_scan(words: Sequence[torch.Tensor], n_part: int,
                perm: torch.Tensor, spec: Tuple,
                arg: Optional[torch.Tensor] = None,
                arg_valid: Optional[torch.Tensor] = None,
                default: Optional[torch.Tensor] = None,
                default_valid: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """One window function over rows sorted by `words` (the first
    `n_part` are partition words), whose original positions are `perm`;
    the lanes are in sorted order too. Returns tensors in original row
    order: ranks and ntile {"data"} (int64, or float64 for percent_rank and
    cume_dist); shift {"data" in the value's dtype, "valid"}; agg {"sum"
    (int64 or float64, not for cnt), "cnt"}.

    On CPU tensors this runs `window_scan_plain`; on CUDA tensors it
    launches the `window_scan` kernel (`scan_launches` launches) or
    raises."""
    lanes = (arg, arg_valid, default, default_valid)
    _check(words, n_part, perm, spec, lanes)
    if not groupby._cuda(perm):
        return window_scan_plain(words, n_part, perm, spec, *lanes)
    n, dev = perm.numel(), perm.device
    outs = _new_outputs(spec, n, arg, dev)
    if n == 0:
        return outs
    fields, arrays, halo = _pass_plan(spec)
    tiles = -(-n // TILE)
    shift = spec[0] == "shift"
    code = _spec_words(spec)
    lib = kernels.library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    def ints(want):
        return torch.empty(n, dtype=torch.int64, device=dev) if want else None
    with torch.cuda.device(dev):
        stream = groupby._stream(dev)
        ptrs = (ctypes.c_void_p * max(len(words), 1))(
            *[w.data_ptr() for w in words])
        widths = (ctypes.c_int * max(len(words), 1))(
            *[w.element_size() for w in words])
        # the tiles' status words and counter (zeroed), their records, and
        # a one-pass frame's prefix sums of each tile's last rows
        state = torch.zeros(tiles + 1, dtype=torch.int64, device=dev)
        records = torch.empty(2 * tiles * RECORD, dtype=torch.int64,
                              device=dev)
        frame = bool(fields & F_CNT) and not arrays
        halo_out = torch.empty(tiles * 2 * halo, dtype=torch.int64,
                               device=dev) if frame and halo > 1 else None
        # the second launch's inputs: only those its function reads
        peers = bool(fields & F_QS)
        inputs = [ints(arrays), ints(arrays and peers),
                  ints(arrays and bool(fields & (F_SUM_I | F_SUM_F))),
                  ints(arrays and bool(fields & F_CNT)), ints(arrays),
                  ints(arrays and peers)]
        evals = (ctypes.c_void_p * 6)(*[ptr(t) for t in inputs])
        val = arg if shift or fields & (F_SUM_I | F_SUM_F) else None
        kernels.check(lib.dft_window_pass(
            ptrs, widths, len(words), n_part, n,
            code.ctypes.data_as(ctypes.c_void_p), fields, halo, int(arrays),
            perm.data_ptr(), ptr(val),
            ptr(arg_valid) if shift or spec[0] == "agg" else None,
            ptr(default), ptr(default_valid),
            arg.element_size() if shift else 8,
            ptr(outs.get("data", outs.get("sum"))),
            ptr(outs.get("valid", outs.get("cnt"))), evals, state.data_ptr(),
            records.data_ptr(), ptr(halo_out), tiles, stream),
            window_scan_kernel)
        window_scan_kernel.launches += 1 + arrays
    return outs


def _new_outputs(spec: Tuple, n: int, arg: Optional[torch.Tensor],
                 dev: torch.device) -> Dict[str, torch.Tensor]:
    kind = spec[0]
    if kind == "rank":
        dtype = torch.float64 if spec[1] in ("percent_rank", "cume_dist") \
            else torch.int64
        return {"data": torch.empty(n, dtype=dtype, device=dev)}
    if kind == "ntile":
        return {"data": torch.empty(n, dtype=torch.int64, device=dev)}
    if kind == "shift":
        return {"data": torch.empty(n, dtype=arg.dtype, device=dev),
                "valid": torch.empty(n, dtype=torch.bool, device=dev)}
    outs = {"cnt": torch.empty(n, dtype=torch.int64, device=dev)}
    if spec[1] != "cnt":
        outs["sum"] = torch.empty(n, dtype=arg.dtype, device=dev)
    return outs


def window_scan_plain(words: Sequence[torch.Tensor], n_part: int,
                      perm: torch.Tensor, spec: Tuple,
                      arg: Optional[torch.Tensor] = None,
                      arg_valid: Optional[torch.Tensor] = None,
                      default: Optional[torch.Tensor] = None,
                      default_valid: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version: `_build_step` after its sort, line by
    line, with a scatter through `perm` in place of its second sort."""
    n, dev = perm.numel(), perm.device
    if n == 0:
        return _new_outputs(spec, 0, arg, dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    start = torch.zeros(n, dtype=torch.bool, device=dev)
    start[0] = True
    for w in words[:n_part]:
        start[1:] |= w[1:] != w[:-1]
    new_peer = start.clone()
    for w in words[n_part:]:
        new_peer[1:] |= w[1:] != w[:-1]

    def cummax(x):
        return torch.cummax(x, 0).values

    def ffill_right(mask):
        """For each row, the index of the nearest marked row at or after
        it: a cummax over the flipped, reversed-coordinate indices."""
        enc = torch.where(mask, (n - 1) - idx, -1)
        return (n - 1) - torch.flip(cummax(torch.flip(enc, [0])), [0])

    part_start = cummax(torch.where(start, idx, 0))
    part_end = ffill_right(torch.cat([start[1:], one]))
    row_in_part = idx - part_start
    part_len = part_end - part_start + 1

    kind = spec[0]
    outs = {}
    if kind == "rank":
        name = spec[1]
        if name == "row_number":
            outs["data"] = row_in_part + 1
        elif name == "rank":
            set_idx = cummax(torch.where(new_peer, idx, 0))
            outs["data"] = set_idx - part_start + 1
        elif name == "dense_rank":
            dr = torch.cumsum(new_peer.to(torch.int64), 0)
            outs["data"] = dr - dr[part_start] + 1
        elif name == "percent_rank":
            set_idx = cummax(torch.where(new_peer, idx, 0))
            rank = set_idx - part_start + 1
            denom = torch.clamp(part_len - 1, min=1).to(torch.float64)
            outs["data"] = (rank - 1).to(torch.float64) / denom
        else:   # cume_dist
            peer_end = ffill_right(torch.cat([new_peer[1:], one]))
            outs["data"] = (peer_end - part_start + 1).to(torch.float64) / \
                part_len.to(torch.float64)
    elif kind == "ntile":
        k = int(spec[1])
        outs["data"] = torch.clamp(
            row_in_part * k // torch.clamp(part_len, min=1) + 1, max=k)
    elif kind == "shift":
        src = idx + int(spec[1])
        in_part = (src >= part_start) & (src <= part_end)
        safe = torch.clamp(src, 0, n - 1)
        valid = arg_valid if arg_valid is not None else \
            torch.ones(n, dtype=torch.bool, device=dev)
        data = arg[safe]
        v = valid[safe] & in_part
        if default is not None:
            dv = default_valid if default_valid is not None else \
                torch.ones(n, dtype=torch.bool, device=dev)
            data = torch.where(in_part, data, default)
            v = torch.where(in_part, v, dv)
        outs["data"] = data
        outs["valid"] = v
    elif kind == "agg":
        _, agg_kind, lo_kind, lo_off, hi_kind, hi_off = spec
        peer_end = ffill_right(torch.cat([new_peer[1:], one]))
        peer_start = cummax(torch.where(new_peer, idx, 0))

        def bound(bk, boff, is_lo):
            if bk == "part":
                return part_start if is_lo else part_end
            if bk == "cur":
                return idx
            if bk == "peer":
                return peer_start if is_lo else peer_end
            return idx + int(boff)        # "rows"
        lo = torch.maximum(bound(lo_kind, lo_off, True), part_start)
        hi = torch.minimum(bound(hi_kind, hi_off, False), part_end)
        empty = lo > hi
        valid = arg_valid if arg_valid is not None else \
            torch.ones(n, dtype=torch.bool, device=dev)
        hi_c = torch.clamp(hi, 0, n - 1)
        lo_c = torch.clamp(lo - 1, 0, n - 1)
        if agg_kind != "cnt":
            x = torch.where(valid, arg, torch.zeros((), dtype=arg.dtype,
                                                    device=dev))
            ps = torch.cumsum(x, 0)
            fsum = ps[hi_c] - torch.where(lo >= 1, ps[lo_c],
                                          torch.zeros_like(ps[lo_c]))
            outs["sum"] = torch.where(empty, torch.zeros_like(fsum), fsum)
        pc = torch.cumsum(valid.to(torch.int64), 0)
        fcnt = pc[hi_c] - torch.where(lo >= 1, pc[lo_c], 0)
        outs["cnt"] = torch.where(empty, 0, fcnt)
    else:
        raise ValueError(kind)

    out = {}
    for key, v in outs.items():     # back to the original row order
        res = torch.empty_like(v)
        res[perm] = v
        out[key] = res
    return out


def window_eval(words: Sequence[torch.Tensor], n_part: int, spec: Tuple,
                arg: Optional[torch.Tensor] = None,
                arg_valid: Optional[torch.Tensor] = None,
                default: Optional[torch.Tensor] = None,
                default_valid: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """One window function over all rows: sort by the words, carry the
    words and lanes into sorted order, scan. Outputs as `window_scan`'s,
    in original row order."""
    with record_function("dft.window.sort"):
        perm = radix_sort(words)
    extras = [x for x in (arg, arg_valid, default, default_valid)
              if x is not None]
    with record_function("dft.window.gather"):
        moved = reorder_rows(perm, list(words) + extras)
    sorted_words, rest = moved[:len(words)], iter(moved[len(words):])
    lanes = [None if x is None else next(rest)
             for x in (arg, arg_valid, default, default_valid)]
    del moved, rest
    with record_function("dft.window.scan"):
        return window_scan(sorted_words, n_part, perm, spec, *lanes)


def _stage(a: Optional[np.ndarray], n: int, device: torch.device,
           raw: bool) -> Optional[torch.Tensor]:
    """A host lane on `device`: bool validity as is, a shifted value as raw
    bytes of its width (any dtype), a summed value as is."""
    if a is None:
        return None
    a = np.ascontiguousarray(np.asarray(a)[:n])
    if raw and a.dtype != np.bool_:
        a = a.view(_RAW[a.dtype.itemsize])
    return torch.from_numpy(a).to(device)


def stage_window(part_words: List[np.ndarray],
                 order_words: List[np.ndarray], n: int, spec: Tuple,
                 arg: Optional[np.ndarray] = None,
                 arg_valid: Optional[np.ndarray] = None,
                 default: Optional[np.ndarray] = None,
                 default_valid: Optional[np.ndarray] = None, *,
                 device: torch.device
                 ) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
    """The host words and lanes of one window function as `window_eval`
    takes them on `device`: (words, [arg, arg_valid, default,
    default_valid]). A lag/lead value moves as raw bytes of its width, a
    count reads only the validity, and a missing validity is all valid."""
    shift = spec[0] == "shift"
    if spec[:2] == ("agg", "cnt"):
        arg = None
        if arg_valid is None:
            arg_valid = np.ones(n, bool)
    elif arg is not None and arg_valid is None:
        arg_valid = np.ones(n, bool)
    if default is not None and default_valid is None:
        default_valid = np.ones(n, bool)
    words = [to_word(w[:n]).to(device)
             for w in list(part_words) + list(order_words)]
    lanes = [_stage(arg, n, device, shift),
             _stage(arg_valid, n, device, False),
             _stage(default, n, device, shift),
             _stage(default_valid, n, device, False)]
    return words, lanes


def device_window_eval(part_words: List[np.ndarray],
                       order_words: List[np.ndarray], n: int, spec: Tuple,
                       arg: Optional[np.ndarray] = None,
                       arg_valid: Optional[np.ndarray] = None,
                       default: Optional[np.ndarray] = None,
                       default_valid: Optional[np.ndarray] = None, *,
                       device: torch.device) -> Dict[str, np.ndarray]:
    """One window function over `n` host rows on `device`; numpy arrays in
    original row order, keyed as the JAX package's: ranks {"data"}, shift
    {"data", "valid"}, agg {"sum", "cnt"} ({"cnt"} alone for cnt)."""
    with record_function("dft.window.h2d"):
        words, lanes = stage_window(part_words, order_words, n, spec, arg,
                                    arg_valid, default, default_valid,
                                    device=device)
    out = window_eval(words, len(part_words), spec, *lanes)
    del words, lanes
    with record_function("dft.window.d2h"):
        host = {k: v.cpu().numpy() for k, v in out.items()}
    if spec[0] == "shift":
        host["data"] = host["data"].view(np.asarray(arg).dtype)
    return host
